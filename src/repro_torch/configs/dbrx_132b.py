"""dbrx-132b [hf:databricks/dbrx-base]: fine-grained MoE.
40L d_model=6144 48H (kv=8) d_ff=10752, 16 experts top-4 vocab=100352;
head_dim = 6144/48 = 128. bf16 parameters and sort dispatch, as the JAX
package's config, and its training setting (Adafactor)."""
import functools

import torch

from repro_torch.configs import lm_common
from repro_torch.configs.lm_common import FAMILY, SHAPE_DEFS  # noqa: F401
from repro_torch.models.transformer import TransformerConfig

CFG = TransformerConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=10752, vocab=100352, head_dim=128,
    n_experts=16, top_k=4, moe_impl="sort",
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)

TRAIN = lm_common.TrainSetting(optimizer="adafactor", accum=8, lr=1e-4)

build_smoke = functools.partial(lm_common.build_smoke, CFG, TRAIN)

ARCH = lm_common.make_arch("dbrx-132b", CFG, TRAIN)
