"""Port Mamba layer on the CPU against ``repro.models.ssm``: ``mamba_apply_dense``
fresh (kernel path and loop path), from a carried state, and at one token,
and ``mamba_apply_decode``, on the same numpy weights (jamba smoke width,
fp32). The JAX kernel path runs its Pallas scan in interpret mode, as the
JAX package's own tests run it on the CPU. Tolerance 5e-4, the reference's
end-to-end tolerance: a layer's output goes through four products and the
recurrence."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import ssm

from _torch_util import as_np

ARCH = "jamba-1.5-large-398b"
TOL = 5e-4


def _cfgs():
    return (get_smoke_config(ARCH).scaled(dtype="float32"),
            jax_smoke_config(ARCH).scaled(dtype="float32"))


def _params(cfg, seed):
    """Random leaves with the specs' shapes; ``a_log`` and ``d_skip`` near
    their init (1) with noise, so that every channel decays differently."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in ssm.mamba_param_specs(cfg).items():
        x = rng.standard_normal(spec.shape)
        if spec.init in ("ones", "zeros"):
            x = (1.0 if spec.init == "ones" else 0.0) + 0.1 * x
        else:
            x = x / np.sqrt(spec.shape[0])
        out[name] = x.astype(np.float32)
    return out


def _state(cfg, seed, b):
    rng = np.random.default_rng(seed)
    d_in = cfg.ssm.expand * cfg.d_model
    return (rng.standard_normal((b, d_in, cfg.ssm.d_state)).astype(np.float32),
            rng.standard_normal((b, cfg.ssm.d_conv - 1, d_in)).astype(np.float32))


def _run_both(params, x, state, use_kernel):
    cfg, jcfg = _cfgs()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    t_state = j_state = None
    if state is not None:
        t_state = ssm.MambaState(*(torch.from_numpy(s) for s in state))
        j_state = jssm.MambaState(*(jnp.asarray(s) for s in state))
    with torch.inference_mode():
        got = ssm.mamba_apply_dense(cfg, tp, torch.from_numpy(x), t_state,
                                    use_kernel=use_kernel)
    want = jssm.mamba_apply_dense(jcfg, jp, jnp.asarray(x), j_state,
                                  use_kernel=use_kernel)
    return got, want


def _close(got, want):
    (out, st), (j_out, j_st) = got, want
    assert out.shape == j_out.shape and out.dtype == torch.float32
    assert st.h.dtype == torch.float32 and st.h.shape == j_st.h.shape
    assert st.conv.shape == j_st.conv.shape
    np.testing.assert_allclose(as_np(out), as_np(j_out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(as_np(st.h), as_np(j_st.h), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(as_np(st.conv), as_np(j_st.conv), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["loop", "kernel"])
@pytest.mark.parametrize("case", ["fresh", "carried", "one-token", "one-token-carried"])
def test_mamba_apply_dense_matches_jax(case, use_kernel):
    """The kernel is taken only for a fresh state and more than one token;
    every other case runs the loop on both sides, whatever ``use_kernel``."""
    cfg, _ = _cfgs()
    seq = 1 if case.startswith("one-token") else 24
    params = _params(cfg, 1)
    x = np.random.default_rng(2).standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    state = _state(cfg, 3, 2) if case.endswith("carried") else None
    _close(*_run_both(params, x, state, use_kernel))


def test_mamba_kernel_path_is_taken_only_when_fresh_and_multi_token(monkeypatch):
    cfg, _ = _cfgs()
    tp = {k: torch.from_numpy(v) for k, v in _params(cfg, 4).items()}
    calls = []
    real = ops.ssm_scan
    monkeypatch.setattr(ops, "ssm_scan", lambda *a: calls.append(a[0].shape) or real(*a))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32))
    st = ssm.init_mamba_state(cfg, 2, torch.float32, device="cpu")
    with torch.inference_mode():
        ssm.mamba_apply_dense(cfg, tp, x, None, use_kernel=True)
        ssm.mamba_apply_dense(cfg, tp, x, st, use_kernel=True)
        ssm.mamba_apply_dense(cfg, tp, x[:, :1], None, use_kernel=True)
        ssm.mamba_apply_dense(cfg, tp, x, None, use_kernel=False)
    assert calls == [(2, 6, cfg.ssm.expand * cfg.d_model)]


def test_mamba_apply_decode_matches_jax():
    """Three decode steps from a prefill's state equal the JAX package's,
    and equal the fresh full-sequence pass at the same positions."""
    cfg, jcfg = _cfgs()
    params = _params(cfg, 6)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    x = np.random.default_rng(7).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    with torch.inference_mode():
        full, _ = ssm.mamba_apply_dense(cfg, tp, torch.from_numpy(x))
        _, st = ssm.mamba_apply_dense(cfg, tp, torch.from_numpy(x[:, :9]),
                                      use_kernel=True)
    _, j_st = jssm.mamba_apply_dense(jcfg, jp, jnp.asarray(x[:, :9]), use_kernel=True)
    for t in range(9, 12):
        with torch.inference_mode():
            out, st = ssm.mamba_apply_decode(cfg, tp, torch.from_numpy(x[:, t:t + 1]), st)
        j_out, j_st = jssm.mamba_apply_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), j_st)
        np.testing.assert_allclose(as_np(out), as_np(j_out), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(as_np(st.h), as_np(j_st.h), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(as_np(out[:, 0]), as_np(full[:, t]), atol=TOL, rtol=TOL)


def test_init_mamba_state():
    cfg, _ = _cfgs()
    st = ssm.init_mamba_state(cfg, 3, torch.bfloat16, device="cpu")
    d_in = cfg.ssm.expand * cfg.d_model
    assert st.h.shape == (3, d_in, cfg.ssm.d_state) and st.h.dtype == torch.float32
    assert st.conv.shape == (3, cfg.ssm.d_conv - 1, d_in) and st.conv.dtype == torch.bfloat16
    assert float(st.h.abs().sum()) == 0.0 and float(st.conv.abs().sum()) == 0.0
    assert ssm._dt_rank(cfg) == max(1, cfg.d_model // 16)
