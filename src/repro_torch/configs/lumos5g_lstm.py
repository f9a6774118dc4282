"""The paper's own proof-of-concept config (Sec. V-VI, Fig. 6).

LSTM encoder (2 x 128 cells) + time-distributed Dense decoder; phase-2
bottleneck LSTM of 32 cells; T=20 timesteps, 11 Lumos5G features,
lr=1e-2, batch=256.
"""
from repro_torch.configs.base import LSTMConfig

CONFIG = LSTMConfig()


def reduced() -> LSTMConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, enc_cells=(32, 32), bottleneck_cells=8, dec_hidden=(16,),
        seq_len=8)
