"""from_jax_X is the inverse of freqfusion_tpu.convert.convert_X:
convert_X(from_jax_X(P)) == P leaf for leaf, for every family, and
from_jax_X(P) loads strictly into the port's module and gives back the
state dict P came from."""

import numpy as np
import pytest
import torch

from freqfusion_tpu.convert.drct import convert_drct
from freqfusion_tpu.convert.fusion import convert_fusion
from freqfusion_tpu.convert.grl import convert_grl
from freqfusion_tpu.convert.mambair import convert_mambair
from freqfusion_tpu.convert.nafnet import convert_nafnet
from freqfusion_tpu_torch.convert import from_jax
from freqfusion_tpu_torch.models.drct import DRCT
from freqfusion_tpu_torch.models.fusion.fusion_v2 import (
    CompleteEnhancedFusionSR)
from freqfusion_tpu_torch.models.grl import GRL
from freqfusion_tpu_torch.models.mambair import MambaIR
from freqfusion_tpu_torch.models.nafnet import NAFNetSR

from test_torch_harness import perturb

FAMILIES = {
    "nafnet": (NAFNetSR, dict(width=16, middle_blk_num=1,
                              enc_blk_nums=(1, 1), dec_blk_nums=(1, 1)),
               from_jax.from_jax_nafnet, convert_nafnet),
    "drct": (DRCT, dict(embed_dim=24, num_layers=2, num_heads=6,
                        window_size=8, gc=8),
             from_jax.from_jax_drct, convert_drct),
    "grl": (GRL, dict(embed_dim=24, depths=(2, 1), num_heads_w=3,
                      num_heads_s=3, window_size=8),
            from_jax.from_jax_grl, convert_grl),
    "mamba": (MambaIR, dict(embed_dim=32, depths=(1, 2)),
              from_jax.from_jax_mamba, convert_mambair),
    "fusion": (CompleteEnhancedFusionSR, {}, from_jax.from_jax_fusion,
               convert_fusion),
}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_from_jax_inverts_convert(family):
    cls, cfg, inverse, convert = FAMILIES[family]
    sd = perturb(cls(**cfg, generator=torch.Generator().manual_seed(3)), 3)
    params = convert(sd)

    back_sd = inverse(params)
    model = cls(**cfg, generator=torch.Generator().manual_seed(4))
    model.load_state_dict(back_sd, strict=True)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)

    want = dict(_flat(params))
    got = dict(_flat(convert({k: v.numpy() for k, v in back_sd.items()})))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
