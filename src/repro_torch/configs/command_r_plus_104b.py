"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01 family]: dense GQA
LM, no biases. 64L d_model=12288 96H (kv=8) d_ff=33792 vocab=256000;
head_dim = 12288/96 = 128. bf16 parameters, as the JAX package's config,
and its training setting (Adafactor)."""
import functools

import torch

from repro_torch.configs import lm_common
from repro_torch.configs.lm_common import FAMILY, SHAPE_DEFS  # noqa: F401
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
    n_kv_heads=8, d_ff=33792, vocab=256000, head_dim=128,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)

TRAIN = lm_common.TrainSetting(optimizer="adafactor", accum=4, lr=1e-4,
                               train_rules="residual_sp")

build_smoke = functools.partial(lm_common.build_smoke, CFG, TRAIN)

ARCH = lm_common.make_arch("command-r-plus-104b", CFG, TRAIN)
