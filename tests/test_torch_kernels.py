"""Port kernels on the CPU: the plain PyTorch versions of the attention, WKV
and selective-scan kernels and the ``ops`` dispatch layer, held against the
JAX package's oracles (``repro.kernels.ref``) and its Pallas kernels in
interpret mode, on the same numpy inputs. Tolerances are the reference's
own: 5e-5 in fp32, 2e-2 in bf16, four times both for the two recurrences."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rwkv6_wkv import rwkv6_wkv as jax_wkv
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_wkv as wkv_k
from repro_torch.kernels import ssm_scan as ssm_k

from _torch_util import as_np, to_jax, to_torch

TOL = {False: 5e-5, True: 2e-2}

FLASH_SHAPES = [
    (1, 4, 4, 128, 64),       # MHA
    (2, 8, 2, 256, 64),       # GQA 4:1
    (1, 4, 1, 192, 128),      # MQA, ragged seq vs block
    (1, 4, 2, 192, 256),      # gemma2's head dim, GQA 2:1
]
FLASH_OPTS = [(None, 0.0), (64, 0.0), (None, 30.0)]
DECODE_SHAPES = [(2, 4, 2, 256, 64), (1, 8, 1, 128, 128), (2, 2, 8, 192, 64),
                 (2, 8, 3, 96, 16)]


def _qkv(seed, b, h, kv, sq, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, kv, s, d)).astype(np.float32),
            rng.standard_normal((b, kv, s, d)).astype(np.float32))


def _close(got, want, bf16):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=TOL[bf16],
                               rtol=TOL[bf16])


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,kv,s,d", FLASH_SHAPES)
@pytest.mark.parametrize("window,softcap", FLASH_OPTS)
def test_flash_plain_vs_jax_oracle_and_pallas(b, h, kv, s, d, window, softcap, bf16):
    q, k, v = _qkv(1, b, h, kv, s, s, d)
    tq, tk, tv = (to_torch(x, bf16) for x in (q, k, v))
    jq, jk, jv = (to_jax(x, bf16) for x in (q, k, v))
    out, lse = fa_k.flash_attention(tq, tk, tv, window=window, softcap=softcap,
                                    return_lse=True)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    _close(out, jref.flash_attention_ref(jq, jk, jv, window=window,
                                         softcap=softcap), bf16)
    p_out, p_lse = jax_flash(jq, jk, jv, window=window, softcap=softcap,
                             interpret=True, block_q=64, block_k=64,
                             return_lse=True)
    _close(out, p_out, bf16)
    _close(lse, p_lse, bf16)
    # the port's own oracle agrees with the JAX one
    _close(ref.flash_attention_ref(tq, tk, tv, window=window, softcap=softcap),
           jref.flash_attention_ref(jq, jk, jv, window=window, softcap=softcap),
           bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("window,softcap", FLASH_OPTS)
def test_ops_flash_model_layout(window, softcap, bf16):
    """``ops.flash_attention`` takes (B,S,H,D) and hands strided views on;
    with and without ``force_ref`` it matches the JAX oracle."""
    b, h, kv, s, d = 2, 8, 2, 96, 16
    q, k, v = _qkv(2, b, h, kv, s, s, d)
    jq, jk, jv = (to_jax(x, bf16) for x in (q, k, v))
    want = jnp.swapaxes(jref.flash_attention_ref(
        jq, jk, jv, window=window, softcap=softcap), 1, 2)
    tq, tk, tv = (to_torch(x, bf16).transpose(1, 2).contiguous() for x in (q, k, v))
    for force in (False, True):
        ops.force_ref(force)
        try:
            got = ops.flash_attention(tq, tk, tv, window=window,
                                      attn_softcap=softcap)
        finally:
            ops.force_ref(False)
        assert got.shape == (b, s, h, d)
        _close(got, want, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("window", [None, 48])
def test_flash_q_offset(window, bf16):
    """A q shard at ``q_offset`` against whole K/V equals those rows of the
    full result, in the port and in the Pallas kernel."""
    b, h, kv, s, d = 1, 4, 2, 128, 64
    off = 64
    q, k, v = _qkv(3, b, h, kv, s, s, d)
    tq, tk, tv = (to_torch(x, bf16) for x in (q, k, v))
    full, full_lse = fa_k.flash_attention(tq, tk, tv, window=window, return_lse=True)
    part, part_lse = fa_k.flash_attention(tq[:, :, off:], tk, tv, window=window,
                                          q_offset=off, return_lse=True)
    _close(part, full[:, :, off:], bf16)
    _close(part_lse, full_lse[:, :, off:], bf16)
    jq, jk, jv = (to_jax(x, bf16) for x in (q, k, v))
    p_out, p_lse = jax_flash(jq[:, :, off:], jk, jv, window=window, q_offset=off,
                             interpret=True, block_q=64, block_k=64,
                             return_lse=True)
    _close(part, p_out, bf16)
    _close(part_lse, p_lse, bf16)


def test_flash_non_causal_and_strided_views():
    b, h, kv, sq, s, d = 1, 4, 4, 40, 56, 16
    q, k, v = _qkv(4, b, h, kv, sq, s, d)
    # views with a contiguous last dim only, as the model hands them over
    tq = to_torch(q).transpose(1, 2).contiguous().transpose(1, 2)
    tk = to_torch(k).transpose(1, 2).contiguous().transpose(1, 2)
    tv = to_torch(v).transpose(1, 2).contiguous().transpose(1, 2)
    assert not tq.is_contiguous()
    got = fa_k.flash_attention(tq, tk, tv, causal=False)
    scores = np.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(d)
    probs = np.exp(scores - scores.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    _close(got, np.einsum("bhst,bhtd->bhsd", probs, v), False)


def _decode_inputs(seed, b, kv, g, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s                      # one full row
    mask = np.arange(s)[None, :] < lengths[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("b,kv,g,s,d", DECODE_SHAPES)
def test_decode_plain_vs_jax_oracle_and_pallas(b, kv, g, s, d, softcap, bf16):
    q, k, v, mask = _decode_inputs(5, b, kv, g, s, d)
    tq, tk, tv = (to_torch(x, bf16) for x in (q, k, v))
    jq, jk, jv = (to_jax(x, bf16) for x in (q, k, v))
    out, m, l = dec_k.decode_attention(tq, tk, tv, torch.from_numpy(mask),
                                       softcap=softcap, return_stats=True)
    assert out.shape == (b, kv, g, d) and m.shape == l.shape == (b, kv, g, 1)
    want = jref.decode_attention_ref(jq, jnp.swapaxes(jk, 1, 2),
                                     jnp.swapaxes(jv, 1, 2), jnp.asarray(mask),
                                     softcap=softcap)
    _close(out, want, bf16)
    p_out, p_m, p_l = jax_decode(jq, jk, jv, jnp.asarray(mask), softcap=softcap,
                                 interpret=True, block_k=32, return_stats=True)
    _close(out, p_out, bf16)
    _close(m, p_m, bf16)
    _close(l, p_l, bf16)
    _close(ref.decode_attention_ref(tq, tk.transpose(1, 2), tv.transpose(1, 2),
                                    torch.from_numpy(mask), softcap=softcap),
           want, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_ops_decode_model_layout(bf16):
    b, kv, g, s, d = 2, 2, 3, 64, 16
    q, k, v, mask = _decode_inputs(6, b, kv, g, s, d)
    want = jref.decode_attention_ref(
        to_jax(q, bf16), jnp.swapaxes(to_jax(k, bf16), 1, 2),
        jnp.swapaxes(to_jax(v, bf16), 1, 2), jnp.asarray(mask))
    tq = to_torch(q, bf16).reshape(b, 1, kv * g, d)
    for force in (False, True):
        ops.force_ref(force)
        try:
            got = ops.decode_attention(tq, to_torch(k, bf16), to_torch(v, bf16),
                                       torch.from_numpy(mask))
        finally:
            ops.force_ref(False)
        assert got.shape == (b, 1, kv * g, d)
        _close(got.reshape(b, kv, g, d), want, bf16)


def test_decode_split_merge_rule():
    """The kernel cuts S into chunks and merges the partial (out, m, l) with
    w = exp(m - m*) * l. The same rule applied to the plain version's stats
    over two halves of the cache gives the whole-cache result."""
    b, kv, g, s, d = 2, 2, 3, 64, 16
    q, k, v, mask = _decode_inputs(7, b, kv, g, s, d)
    tq, tk, tv, tm = to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(mask)
    whole, m_w, l_w = dec_k.decode_attention(tq, tk, tv, tm, return_stats=True)
    parts = [dec_k.decode_attention(tq, tk[:, sl], tv[:, sl], tm[:, sl],
                                    return_stats=True)
             for sl in (slice(0, 24), slice(24, s))]
    m_star = torch.maximum(parts[0][1], parts[1][1])
    ws = [torch.exp(m - m_star) * l for _, m, l in parts]
    num = sum(o * w for (o, _, _), w in zip(parts, ws))
    den = sum(ws)
    _close(num / den.clamp_min(1e-30), whole, False)
    _close(m_star, m_w, False)
    _close(den, l_w, False)


def test_wrappers_reject_what_the_kernels_do_not_take():
    assert dec_k.num_splits(8, 8, 1024, 132) == 2     # a cluster of 2 blocks
    assert dec_k.num_splits(1, 1, 32, 132) == 1
    assert dec_k.num_splits(64, 8, 4096, 132) == 1
    x = torch.zeros(2, 8, 4, 16)
    assert fa_k._aligned_view(x) is x
    assert fa_k._aligned_view(x.transpose(1, 2)) is not None
    odd = torch.zeros(2, 8, 4, 17)[..., 1:]
    assert fa_k._aligned_view(odd).is_contiguous()
    assert fa_k.launches == 0 and dec_k.launches == 0   # the CPU never launches
    assert wkv_k.launches == 0 and ssm_k.launches == 0


def _wkv_inputs(seed, bh, s, dk, dv):
    """As ``tests/test_kernels.py`` draws them: decays in (0, 1), small k, u."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((bh, s, dk))
    k = rng.standard_normal((bh, s, dk)) * 0.3
    v = rng.standard_normal((bh, s, dv))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((bh, s, dk))))
    u = rng.standard_normal((bh, dk)) * 0.1
    return tuple(x.astype(np.float32) for x in (r, k, v, w, u))


def _close4(got, want, bf16):
    tol = 4 * TOL[bf16]
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bh,s,dk,dv,chunk", [(4, 64, 32, 32, 16),
                                              (2, 128, 64, 64, 64)])
def test_rwkv6_wkv_plain_vs_jax_oracle_and_pallas(bh, s, dk, dv, chunk, bf16):
    """The JAX kernel test's shapes: the plain version against the JAX oracle
    and the Pallas kernel in interpret mode, and the port's oracle against
    the JAX one."""
    ins = _wkv_inputs(8, bh, s, dk, dv)
    t_in = [to_torch(x, bf16) for x in ins]
    j_in = [to_jax(x, bf16) for x in ins]
    y, st = wkv_k.rwkv6_wkv(*t_in)
    assert y.shape == (bh, s, dv) and y.dtype == t_in[0].dtype
    assert st.shape == (bh, dk, dv) and st.dtype == torch.float32
    y_ref, st_ref = jref.rwkv6_wkv_ref(*j_in)
    _close4(y, y_ref, bf16)
    _close4(st, st_ref, bf16)
    p_y, p_st = jax_wkv(*j_in, interpret=True, chunk=chunk)
    _close4(y, p_y, bf16)
    _close4(st, p_st, bf16)
    o_y, o_st = ref.rwkv6_wkv_ref(*t_in)
    assert o_y.dtype == t_in[0].dtype and o_st.dtype == torch.float32
    _close4(o_y, y_ref, bf16)
    _close4(o_st, st_ref, bf16)


@pytest.mark.parametrize("bh,s,dk,dv", [(2, 200, 16, 16), (3, 1, 16, 8),
                                        (2, 37, 24, 40)],
                         ids=["ragged-s200", "s1-dk16-dv8", "s37-dk24-dv40"])
def test_rwkv6_wkv_ragged_against_oracle(bh, s, dk, dv):
    """S not a multiple of any tile, S = 1, Dk != Dv. Held against the JAX
    oracle only: the Pallas kernel lets rows past S into its last chunk's
    state when S > chunk and S % chunk != 0 (at S = 200, chunk 128 its
    s_final is NaN), which the port must not copy."""
    ins = _wkv_inputs(9, bh, s, dk, dv)
    y, st = wkv_k.rwkv6_wkv(*(to_torch(x) for x in ins))
    assert torch.isfinite(st).all() and torch.isfinite(y).all()
    y_ref, st_ref = jref.rwkv6_wkv_ref(*(to_jax(x) for x in ins))
    _close4(y, y_ref, False)
    _close4(st, st_ref, False)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_ops_rwkv6_wkv(bf16):
    """``ops.rwkv6_wkv`` with and without ``force_ref`` matches the JAX
    oracle; u may come in fp32 beside bf16 inputs, as the model hands it."""
    ins = _wkv_inputs(10, 6, 48, 16, 16)
    want = jref.rwkv6_wkv_ref(*(to_jax(x, bf16) for x in ins[:4]), to_jax(ins[4]))
    t_in = [to_torch(x, bf16) for x in ins[:4]] + [to_torch(ins[4])]
    for force in (False, True):
        ops.force_ref(force)
        try:
            got = ops.rwkv6_wkv(*t_in)
        finally:
            ops.force_ref(False)
        _close4(got[0], want[0], bf16)
        _close4(got[1], want[1], bf16)


def _ssm_inputs(seed, b, s, d, n):
    """As ``tests/test_kernels.py`` draws them: dt = softplus(N(0,1)/2),
    a = -exp(N(0,1) * 0.3)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, d))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)) * 0.5))
    bm = rng.standard_normal((b, s, n))
    cm = rng.standard_normal((b, s, n))
    a = -np.exp(rng.standard_normal((d, n)) * 0.3)
    d_skip = 1.0 + 0.1 * rng.standard_normal(d)
    return tuple(x.astype(np.float32) for x in (u, dt, bm, cm, a, d_skip))


def _ssm_args(ins, bf16, conv):
    """u, dt, bm, cm in the working dtype (as the JAX kernel test has them);
    a and d_skip in fp32."""
    return [conv(x, bf16) for x in ins[:4]] + [conv(x, False) for x in ins[4:]]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,d,n,chunk,block_d", [(2, 128, 96, 8, 32, 32),
                                                   (1, 64, 256, 16, 64, 128)])
def test_ssm_scan_plain_vs_jax_oracle_and_pallas(b, s, d, n, chunk, block_d, bf16):
    """The JAX kernel test's shapes (S a multiple of the chunk): the plain
    version against the JAX oracle and the Pallas kernel in interpret mode,
    and the port's oracle against the JAX one."""
    ins = _ssm_inputs(11, b, s, d, n)
    t_in, j_in = _ssm_args(ins, bf16, to_torch), _ssm_args(ins, bf16, to_jax)
    y, h = ssm_k.ssm_scan(*t_in)
    assert y.shape == (b, s, d) and y.dtype == t_in[0].dtype
    assert h.shape == (b, d, n) and h.dtype == torch.float32
    y_ref, h_ref = jref.ssm_scan_ref(*j_in)
    _close4(y, y_ref, bf16)
    _close4(h, h_ref, bf16)
    p_y, p_h = jax_ssm_scan(*j_in, interpret=True, chunk=chunk, block_d=block_d)
    _close4(y, p_y, bf16)
    _close4(h, p_h, bf16)
    o_y, o_h = ref.ssm_scan_ref(*t_in)
    assert o_y.dtype == t_in[0].dtype and o_h.dtype == torch.float32
    _close4(o_y, y_ref, bf16)
    _close4(o_h, h_ref, bf16)


def _ssm_extreme_inputs(seed, b, s, d, n):
    """dt uniform in [0, 50) and a in (-20, 0]: dt * a reaches about -1000,
    far below where an exp computed from its exponent bits would wrap."""
    u, _, bm, cm, _, d_skip = _ssm_inputs(seed, b, s, d, n)
    rng = np.random.default_rng(seed + 1)
    dt = (rng.random((b, s, d)) * 50).astype(np.float32)
    a = (-rng.random((d, n)) * 20).astype(np.float32)
    return u, dt, bm, cm, a, d_skip


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_ssm_scan_plain_vs_jax_oracle_and_pallas_at_extreme_decay(bf16):
    """A decay exp(dt * a) down to exp(-1000): the plain version, the JAX
    oracle and the Pallas kernel in interpret mode agree, finite, and a
    state that has fully decayed holds only its last input."""
    b, s, d, n = 2, 64, 128, 16
    ins = _ssm_extreme_inputs(14, b, s, d, n)
    assert (ins[1][..., None] * ins[4][None, None]).min() < -900
    t_in, j_in = _ssm_args(ins, bf16, to_torch), _ssm_args(ins, bf16, to_jax)
    y, h = ssm_k.ssm_scan(*t_in)
    assert torch.isfinite(y.float()).all() and torch.isfinite(h).all()
    y_ref, h_ref = jref.ssm_scan_ref(*j_in)
    _close4(y, y_ref, bf16)
    _close4(h, h_ref, bf16)
    p_y, p_h = jax_ssm_scan(*j_in, interpret=True, chunk=32, block_d=128)
    _close4(y, p_y, bf16)
    _close4(h, p_h, bf16)
    # where every decay of the last step is below exp(-100), h_final is the
    # last step's input dt u B alone
    uf, dtf, bmf = (t.float() for t in t_in[:3])
    gone = (dtf[:, -1, :, None] * t_in[4].float()[None]) < -100
    want = (dtf[:, -1] * uf[:, -1])[:, :, None] * bmf[:, -1, None, :]
    assert gone.sum() > 1000
    torch.testing.assert_close(h[gone], want.expand_as(h)[gone], rtol=1e-6, atol=1e-6)


def _ex2_poly_numpy(x):
    """``sm90::ex2_poly`` of ``csrc/sm90.cuh`` emulated bit for bit in numpy:
    its clamp and coefficients read from the header, fp32 Horner steps with each fmaf
    done in float64 (exact for a product of two fp32 values) and rounded once,
    the exponent added to the bits modulo 2^32."""
    import re
    from pathlib import Path
    src = (Path(ssm_k.__file__).parent / "csrc" / "sm90.cuh").read_text()
    body = src[src.index("float ex2_poly(float x)"):]
    body = body[:body.index("\n}\n")]
    coef = [np.float32(c) for c in re.findall(r"p = (?:fmaf\(p, f, )?([0-9.e+-]+)f", body)]
    assert len(coef) == 6 and coef[-1] == 1.0, coef
    floor = np.float32(re.search(r"fmaxf\(x, (-?[0-9.]+)f\)", body).group(1))
    rnd = np.float32(12582912.0)
    x = np.maximum(x.astype(np.float32), floor)
    t = x + rnd
    f = x - (t - rnd)
    p = np.full_like(f, coef[0])
    for c in coef[1:]:
        p = (p.astype(np.float64) * f + np.float64(c)).astype(np.float32)
    bits = (p.view(np.uint32).astype(np.uint64)
            + (t.view(np.uint32).astype(np.uint64) << np.uint64(23))) & np.uint64(0xFFFFFFFF)
    return bits.astype(np.uint32).view(np.float32)


def test_ex2_poly_emulated_bit_for_bit():
    """The FMA-pipe exp of the TMA route: relative error at most 2^-21 (as
    exact as ``ex2.approx.ftz``) where 2^x is a normal number, and from the
    clamp at -127 down to any x, a finite value in [0, 2^-126]: exactly 0 at
    -127 and below, never the NaN an unclamped exponent would wrap to."""
    x = np.concatenate([np.linspace(-140.0, 0.0, 1_400_001, dtype=np.float32),
                        np.float32([-126.5, -126.9, -127.0, -127.5, -1e4, -3e38, -0.0])])
    got = _ex2_poly_numpy(x).astype(np.float64)
    want = np.exp2(x.astype(np.float64))
    normal = want >= 2.0 ** -126
    assert np.abs(got[normal] / want[normal] - 1).max() <= 2.0 ** -21
    assert np.isfinite(got).all() and (got >= 0).all() and got[~normal].max() <= 2.0 ** -126
    assert (got[x <= -127] == 0).all() and got[-1] == 1.0


@pytest.mark.parametrize("dtype,d_in,n,want", [
    (torch.bfloat16, 16384, 16, "tma"),     # jamba-1.5-large's serving shape
    (torch.float32, 16384, 16, "tma"),
    (torch.bfloat16, 1000, 16, "tma"),      # 2000-byte rows
    (torch.float32, 132, 12, "tma"),        # 528-byte rows, N 12
    (torch.bfloat16, 128, 4, "tma"),
    (torch.bfloat16, 130, 16, "simple"),    # 260-byte rows
    (torch.float32, 130, 16, "simple"),     # 520-byte rows
    (torch.bfloat16, 1004, 8, "simple"),    # 2008-byte rows
    (torch.float32, 200, 5, "simple"),      # B and C rows of 20 bytes
    (torch.bfloat16, 1024, 3, "simple"),    # B and C rows of 12 bytes
    (torch.float32, 1024, 1, "simple"),
])
def test_ssm_scan_route_by_dtype_d_in_and_n(dtype, d_in, n, want):
    """K3's route is a function of (dtype, d_in, N) alone: ``tma`` where the
    rows of u, dt and y and of B and C are multiples of 16 bytes."""
    assert ssm_k.ROUTES == ("simple", "tma")
    assert ssm_k.route(dtype, d_in, n) == want


@pytest.mark.parametrize("b,s,d,n", [(2, 200, 32, 8), (3, 1, 40, 16), (1, 37, 50, 5)],
                         ids=["ragged-s200", "s1", "s37-d50-n5"])
def test_ssm_scan_ragged_against_oracle(b, s, d, n):
    """S not a multiple of any chunk, S = 1, d_in and N off every tile. Held
    against the JAX oracle only: the Pallas kernel lets rows past S into its
    last chunk's state when S > chunk and S % chunk != 0 (at S = 200, chunk
    128 its h_final is NaN), which the port must not copy."""
    ins = _ssm_inputs(12, b, s, d, n)
    y, h = ssm_k.ssm_scan(*(to_torch(x) for x in ins))
    assert torch.isfinite(h).all() and torch.isfinite(y).all()
    y_ref, h_ref = jref.ssm_scan_ref(*(to_jax(x) for x in ins))
    _close4(y, y_ref, False)
    _close4(h, h_ref, False)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_ops_ssm_scan(bf16):
    """``ops.ssm_scan`` with and without ``force_ref`` matches the JAX
    oracle, with the model's mixed types: u and dt in the working dtype,
    B, C, a and d_skip in fp32."""
    ins = _ssm_inputs(13, 2, 48, 64, 16)
    want = jref.ssm_scan_ref(*(to_jax(x, bf16) for x in ins[:2]),
                             *(to_jax(x) for x in ins[2:]))
    t_in = [to_torch(x, bf16) for x in ins[:2]] + [to_torch(x) for x in ins[2:]]
    for force in (False, True):
        ops.force_ref(force)
        try:
            y, h = ops.ssm_scan(*t_in)
        finally:
            ops.force_ref(False)
        assert y.dtype == t_in[0].dtype
        _close4(y, want[0], bf16)
        _close4(h, want[1], bf16)


def _wkv_model_inputs(seed, b, s, h, dk, dv, view):
    """The model-layout entry's inputs as numpy (B, S, H, D) arrays, drawn as
    :func:`_wkv_inputs` draws them, and a function that hands one to the
    port as the view the case names: a dense tensor, a column slice of a
    wider one, or a transpose of a (B, H, S, D) one."""
    r, k, v, w, u = _wkv_inputs(seed, b * h, s, dk, dv)
    bshd = [x.reshape(b, h, s, -1).transpose(0, 2, 1, 3) for x in (r, k, v, w)]

    def as_view(x, dtype):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
        if view == "sliced":
            wide = torch.zeros(*t.shape[:-1], t.shape[-1] + 8, dtype=dtype)
            wide[..., :t.shape[-1]] = t
            return wide[..., :t.shape[-1]]
        if view == "transposed":
            return t.transpose(1, 2).contiguous().transpose(1, 2)
        return t
    return bshd, torch.from_numpy(u[:h].copy()), as_view


@pytest.mark.parametrize("view", ["dense", "sliced", "transposed"])
@pytest.mark.parametrize("rkv", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,h,dk,dv", [(2, 37, 3, 16, 24), (1, 1, 2, 8, 8),
                                         (2, 64, 4, 32, 32)])
def test_rwkv6_wkv_model_plain_equals_folded_bit_for_bit(b, s, h, dk, dv, rkv, view):
    """The model-layout entry's plain version (r, k, v in the model's dtype,
    w and u fp32, read through the (B, S, H, D) layout) equals the folded
    call on fp32 copies of the same values bit for bit: bf16 -> fp32 is
    exact and the loop sums in the same order."""
    (r, k, v, w), u, as_view = _wkv_model_inputs(21, b, s, h, dk, dv, view)
    tr, tk, tv = (as_view(x, rkv) for x in (r, k, v))
    tw = as_view(w, torch.float32)
    y, st = wkv_k.rwkv6_wkv_model(tr, tk, tv, tw, u)
    assert y.shape == (b, s, h, dv) and y.dtype == torch.float32
    assert st.shape == (b, h, dk, dv) and st.dtype == torch.float32

    def fold(t):
        return t.float().transpose(1, 2).reshape(b * h, s, t.shape[-1]).contiguous()
    fy, fst = wkv_k.rwkv6_wkv(fold(tr), fold(tk), fold(tv), fold(tw), u.repeat(b, 1))
    assert torch.equal(y, fy.reshape(b, h, s, dv).transpose(1, 2))
    assert torch.equal(st, fst.reshape(b, h, dk, dv))
    assert wkv_k.launches == 0                     # the CPU never launches


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_ops_rwkv6_wkv_model_matches_jax_oracle(bf16):
    """``ops.rwkv6_wkv_model`` with and without ``force_ref`` against the
    JAX oracle on the folded values."""
    b, s, h, dk, dv = 2, 24, 3, 16, 16
    (r, k, v, w), u, as_view = _wkv_model_inputs(23, b, s, h, dk, dv, "dense")
    u = u.numpy()
    rkv = torch.bfloat16 if bf16 else torch.float32
    t_in = [as_view(x, rkv) for x in (r, k, v)] + [as_view(w, torch.float32),
                                                    torch.from_numpy(u)]

    def fold(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, s, -1)
    j_in = ([to_jax(fold(x), bf16) for x in (r, k, v)] + [to_jax(fold(w))]
            + [to_jax(np.tile(u, (b, 1)))])
    want_y, want_st = jref.rwkv6_wkv_ref(*j_in)
    want_y = np.asarray(want_y, np.float32).reshape(b, h, s, dv).transpose(0, 2, 1, 3)
    want_st = np.asarray(want_st, np.float32).reshape(b, h, dk, dv)
    for force in (False, True):
        ops.force_ref(force)
        try:
            y, st = ops.rwkv6_wkv_model(*t_in)
        finally:
            ops.force_ref(False)
        _close4(y, want_y, bf16)
        _close4(st, want_st, bf16)


def test_rwkv6_wkv_model_rejects_what_the_kernel_does_not_take():
    b, s, h, d = 1, 4, 2, 8
    r = torch.zeros(b, s, h, d, dtype=torch.bfloat16)
    w, u = torch.zeros(b, s, h, d), torch.zeros(h, d)
    wkv_k.rwkv6_wkv_model(r, r, r, w, u)                     # the rule: bf16 r/k/v, fp32 w/u
    cols = torch.zeros(b, s, h, 2 * d, dtype=torch.bfloat16)[..., ::2]   # last dim strided
    with pytest.raises(ValueError, match="contiguous"):
        wkv_k.rwkv6_wkv_model(cols, r, r, w, u)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_k.rwkv6_wkv_model(r, r, r, torch.zeros(b, s, h, 2 * d)[..., ::2], u)
    with pytest.raises(TypeError, match="share a dtype"):
        wkv_k.rwkv6_wkv_model(r, r.float(), r, w, u)         # k off r's dtype
    with pytest.raises(TypeError, match="float32"):
        wkv_k.rwkv6_wkv_model(r, r, r, w.bfloat16(), u)      # w must be fp32
    with pytest.raises(TypeError, match="float32"):
        wkv_k.rwkv6_wkv_model(r, r, r, w, u.bfloat16())      # u must be fp32
    with pytest.raises(TypeError, match="share a dtype"):
        wkv_k.rwkv6_wkv_model(r.half(), r.half(), r.half(), w, u)
    with pytest.raises(ValueError, match="shapes"):
        wkv_k.rwkv6_wkv_model(r, r, r, w, torch.zeros(h + 1, d))
    with pytest.raises(ValueError, match=r"\(B, S, H, D\)"):
        wkv_k.rwkv6_wkv_model(r[0], r[0], r[0], w[0], u)
    assert wkv_k.launches == 0


def test_rwkv_time_mix_kernel_path_makes_no_fold_copy(monkeypatch):
    """``rwkv_time_mix(use_kernel=True)`` hands the model-layout entry the
    (B, S, H, D) projections as they are and reshapes y without a copy."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, ssm
    cfg = get_smoke_config("rwkv6-1.6b").scaled(dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    sub = {kk: vv[0] for kk, vv in params["layers"]["sub0"]["rwkv"].items()}
    seen = {}
    real = wkv_k.rwkv6_wkv_model

    def spy(r, k, v, w, u):
        seen.update(shapes=[tuple(t.shape) for t in (r, k, v, w)],
                    contiguous=[t.is_contiguous() for t in (r, k, v, w)],
                    dtypes=(r.dtype, w.dtype, u.dtype))
        return real(r, k, v, w, u)
    monkeypatch.setattr(wkv_k, "rwkv6_wkv_model", spy)
    d, hd = cfg.d_model, cfg.ssm.wkv_head_dim
    x = torch.randn(2, 6, d, generator=torch.Generator().manual_seed(0))
    state = ssm.init_rwkv_state(cfg, 2, dtype=torch.float32, device="cpu")
    ssm.rwkv_time_mix(cfg, sub, x, state, use_kernel=True)
    assert seen["shapes"][0] == (2, 6, d // hd, hd)
    assert all(seen["contiguous"])
    assert seen["dtypes"] == (torch.float32, torch.float32, torch.float32)
