"""Training substrate of the port: the AdamW with freeze masks that
Algorithm 1's cascade trainer (``repro_torch.core.cascade``) steps."""
