"""bfloat16 drift of the port's LM against the reference's, at a depth and
width where it shows (8 layers, and the full depth of rwkv6-7b (32) and
of the MoE configs (granite-moe 32, qwen2-moe 24), at d_model 256,
64-token prompts).

In bf16 every layer rounds its activations, and the last-token logits
drift from the float32 answer of the same weights; for RWKV6 the drift is
large (several percent here, ~0.11 at rwkv6-7b's full size on the H100).
The port must drift no further than the reference does: its bf16 logits
lie within 1.5x the reference's distance from the float32 answer, while
in float32 the two agree to 1e-4 relative.

An MoE is held here and not elementwise in bf16: with random weights the
router is close to uniform, so bf16 rounding sends some tokens to other
experts than float32 does (up to a sixth of the choices in a layer), and
a choice that moves, or a drop that moves with the ranks, makes the last
token's logits jump.  That happens in both packages, at random, so the
distance over a few sequences is a draw, not a measure of rounding: on 2
sequences the port's distance ranged 0.6-2.1 times the reference's over
five prompt seeds.  The MoE cases therefore take 64 sequences, over which
the jumps average out (0.94-1.12 at full depth), and
test_torch_moe.py holds one MoE layer's bf16 rounding, routing fixed, to
the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_parity import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.convert import lm_params_from_numpy

DEEPER = {"llama3-8b": dict(num_heads=4, num_kv_heads=2),
          "rwkv6-7b": dict(num_heads=4, num_kv_heads=4, rwkv_head_size=64),
          "granite-moe-3b-a800m": dict(num_heads=4, num_kv_heads=2, head_dim=64),
          "qwen2-moe-a2.7b": dict(num_heads=4, num_kv_heads=4)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_drift(arch, num_layers, batch=2):
    over = dict(num_layers=num_layers, d_model=256, d_ff=512, vocab_size=1024,
                **DEEPER[arch])
    cfgs = {dt: (dataclasses.replace(jax_get_config(arch, smoke=True), dtype=dt, **over),
                 dataclasses.replace(get_config(arch, smoke=True), dtype=dt, **over))
            for dt in ("bfloat16", "float32")}
    tree = jax.tree.map(np.asarray, jlm.init_params(cfgs["bfloat16"][0],
                                                    jax.random.PRNGKey(0)))
    if arch == "rwkv6-7b":
        u = tree["layers"]["pos0"]["mixer"]["u"]
        tree["layers"]["pos0"]["mixer"]["u"] = (
            np.random.default_rng(7).normal(size=u.shape) * 0.5).astype(np.float32)
    toks = np.random.default_rng(1).integers(1, 1024, (batch, 64)).astype(np.int32)
    logits = {}
    for dt, (jcfg, tcfg) in cfgs.items():
        # the same bf16 weights, upcast for the float32 run
        t = tree if dt == "bfloat16" else jax.tree.map(lambda a: a.astype(np.float32), tree)
        jl, _ = jax.jit(jlm.prefill_forward(jcfg))(
            jax.tree.map(jnp.asarray, t), {"tokens": jnp.asarray(toks),
                                           "targets": jnp.asarray(toks)})
        tl, _ = lm.prefill_forward(tcfg)(lm_params_from_numpy(t, "cpu"),
                                         {"tokens": torch.from_numpy(toks)})
        logits[dt] = np.asarray(jl), tl.numpy()
    (j16, t16), (j32, t32) = logits["bfloat16"], logits["float32"]
    assert _rel(t32, j32) <= 1e-4
    ref_drift = _rel(j16, j32)
    assert 1e-3 < ref_drift                # bf16 really rounds here
    assert _rel(t16, j32) <= 1.5 * ref_drift


@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b"])
def test_bf16_drift_from_float32_is_no_larger_than_the_references(arch):
    _check_drift(arch, num_layers=8)


def test_rwkv6_bf16_drift_at_full_depth_is_no_larger_than_the_references():
    """rwkv6-7b's 32 layers, where its drift is largest on the card."""
    _check_drift("rwkv6-7b", num_layers=32)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_moe_bf16_drift_at_full_depth_is_no_larger_than_the_references(arch):
    """The MoE configs' full depth, a router in every layer, over 64
    sequences."""
    _check_drift(arch, num_layers=get_config(arch).num_layers, batch=64)
