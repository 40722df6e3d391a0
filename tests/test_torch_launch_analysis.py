"""``repro_torch.launch.analysis`` against ``repro.launch.analysis``.

Parameter counts, active parameters (an MoE's routed experts at
``top_k / n_experts``) and 6·N·D / 2·N·D model FLOPs over the port's
``meta`` parameter trees equal the reference's over ``jax.eval_shape``
of the same config, for each of the ten registry archs, as
``tests/test_configs.py`` computes them.  The roofline terms use the
H100's data-sheet peaks and keep the reference's record keys.
"""
import jax
import pytest

from repro import configs as ref_configs
from repro.launch import analysis as ref_analysis
from repro.train.steps import family_module as ref_family
from repro_torch import configs
from repro_torch.launch import analysis
from repro_torch.train.steps import family_module


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_counts_equal_reference(arch):
    rcfg, cfg = ref_configs.get(arch), configs.get(arch)
    mod = ref_family(rcfg)
    want = jax.eval_shape(lambda k: mod.init(k, rcfg), jax.random.PRNGKey(0))
    got = family_module(cfg).init(None, cfg, device="meta")
    assert analysis.count_params(got) == ref_analysis.count_params(want)
    assert analysis.active_params(cfg, got) == \
        ref_analysis.active_params(rcfg, want)
    for kind, tokens in (("train", 256 * 4096), ("serve", 128)):
        assert analysis.model_flops(cfg, got, tokens, kind) == \
            ref_analysis.model_flops(rcfg, want, tokens, kind)


def test_moe_active_share():
    """llama4: about 400 B parameters, about 17 B active."""
    cfg = configs.get("llama4_maverick_400b_a17b")
    ps = family_module(cfg).init(None, cfg, device="meta")
    assert 3.5e11 < analysis.count_params(ps) < 4.6e11
    assert 1.2e10 < analysis.active_params(cfg, ps) < 2.2e10


def test_roofline_terms_on_h100_peaks():
    assert (analysis.PEAK_FLOPS_BF16, analysis.HBM_BW, analysis.NVLINK_BW) \
        == (989.4e12, 3.35e12, 450e9)
    r = analysis.Roofline(flops=2 * 989.4e12, bytes_accessed=3.35e12,
                          collective_link_bytes=450e9 / 2, collectives={},
                          model_flops_per_device=989.4e12)
    assert (r.compute_s, r.memory_s, r.collective_s) == (2.0, 1.0, 0.5)
    assert r.dominant == "compute" and r.step_s == 2.0
    assert r.mfu == 0.5 and r.useful_flops_ratio == 0.5
    want = ref_analysis.Roofline(flops=1.0, bytes_accessed=1.0,
                                 collective_link_bytes=1.0,
                                 collectives={}).to_dict()
    assert set(r.to_dict()) == set(want)
    mem = analysis.memory_dict(171_168_964)
    assert mem == {"argument_size_in_bytes": 171_168_964,
                   "peak_bytes_per_device": None}
