"""arctic-480b [hf:Snowflake/snowflake-arctic-base]: dense-MoE hybrid.
35L d_model=7168 56H (kv=8) d_ff=4864(dense residual) vocab=32000,
MoE 128 experts top-2 (expert d_ff=4864) + dense residual path;
head_dim = 7168/56 = 128. bf16 parameters and sort dispatch, as the JAX
package's config, and its training setting (Adafactor)."""
import functools

import torch

from repro_torch.configs import lm_common
from repro_torch.configs.lm_common import FAMILY, SHAPE_DEFS  # noqa: F401
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="arctic-480b", n_layers=35, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=4864, vocab=32000, head_dim=128,
    n_experts=128, top_k=2, moe_dense_residual=True, moe_impl="sort",
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)

TRAIN = lm_common.TrainSetting(optimizer="adafactor", accum=8, lr=1e-4,
                               train_rules="residual_sp")

build_smoke = functools.partial(lm_common.build_smoke, CFG, TRAIN)

ARCH = lm_common.make_arch("arctic-480b", CFG, TRAIN)
