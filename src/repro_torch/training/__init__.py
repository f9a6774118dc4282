"""Training substrate of the port: the AdamW with freeze masks that
Algorithm 1's cascade trainer (``repro_torch.core.cascade``) steps, the
transformer training loop (``loop``) and checkpoints in the reference's
``.npz`` layout (``checkpoint``)."""
