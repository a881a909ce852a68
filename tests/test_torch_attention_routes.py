"""The attention kernels' host-side choices and edge rows, on the CPU.

* Decode attention on a row whose mask is all False: the TPU kernel masks
  with ``NEG_INF = -1e30`` and no special case, so such a row gives the mean
  of V with ``m = -1e30`` and ``l = S``. The port's plain version (the CPU
  path and the card's reference) must give the same. The JAX oracle
  ``decode_attention_ref`` masks with ``-inf`` and gives NaN there, so these
  cases are held against the Pallas kernel in interpret mode only.
* The flash-attention route: a (dtype, head dim) alone picks the kernel.
* The decode split: how many shares a row's valid slots are cut into, and
  the cluster of blocks that takes them.

Inputs are made with numpy from a seed and handed to both frameworks;
tolerances are the reference's own (5e-5 fp32, 2e-2 bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import ops

from _torch_util import as_np, to_jax, to_torch

TOL = {False: 5e-5, True: 2e-2}


def _close(got, want, bf16):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=TOL[bf16],
                               rtol=TOL[bf16])


def _masked_inputs(seed, b, kv, g, s, d, lengths):
    """Row i has a prefix of ``lengths[i]`` valid slots (0: all masked);
    a length of -1 makes a random mask with at least one valid slot."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    mask = np.zeros((b, s), bool)
    for i, n in enumerate(lengths):
        if n < 0:
            mask[i] = rng.random(s) < 0.4
            mask[i, s // 2] = True
        else:
            mask[i, :n] = True
    return q, k, v, mask


# (b, kv, g, s, d, lengths): S a multiple of the Pallas kernel's block_k 32
ALL_MASKED_CASES = [
    (2, 2, 3, 64, 16, [0, 40]),           # the case of the reference check
    (3, 1, 8, 96, 64, [0, 1, -1]),        # G = 8, one valid slot, a random row
    (2, 4, 1, 32, 128, [32, 0]),          # G = 1, the full row first
]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,kv,g,s,d,lengths", ALL_MASKED_CASES)
def test_decode_all_masked_row_matches_pallas(b, kv, g, s, d, lengths, bf16, softcap):
    q, k, v, mask = _masked_inputs(11, b, kv, g, s, d, lengths)
    tq, tk, tv = (to_torch(x, bf16) for x in (q, k, v))
    jq, jk, jv = (to_jax(x, bf16) for x in (q, k, v))
    out, m, l = dec_k.decode_attention_plain(tq, tk, tv, torch.from_numpy(mask),
                                             softcap=softcap, return_stats=True)
    p_out, p_m, p_l = jax_decode(jq, jk, jv, jnp.asarray(mask), softcap=softcap,
                                 interpret=True, block_k=32, return_stats=True)
    _close(out, p_out, bf16)
    _close(m, p_m, bf16)
    _close(l, p_l, bf16)
    # what the TPU kernel's arithmetic makes of an empty row
    for i, n in enumerate(lengths):
        if n == 0:
            assert np.all(as_np(m[i]) == np.float32(dec_k.NEG_INF))
            assert np.all(as_np(l[i]) == s)
            mean_v = as_np(tv[i]).mean(axis=0)             # (KV, D)
            _close(out[i], np.broadcast_to(mean_v[:, None, :], (kv, g, d)), bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_ops_decode_all_masked_row(bf16):
    """The model-layout entry point on the CPU gives the same for an empty
    row as the kernel's wrapper."""
    b, kv, g, s, d = 2, 2, 3, 64, 16
    q, k, v, mask = _masked_inputs(12, b, kv, g, s, d, [0, 17])
    tq, tk, tv, tm = (to_torch(q, bf16), to_torch(k, bf16), to_torch(v, bf16),
                      torch.from_numpy(mask))
    got = ops.decode_attention(tq.reshape(b, 1, kv * g, d), tk, tv, tm)
    want = dec_k.decode_attention(tq, tk, tv, tm)
    assert torch.equal(got.reshape(b, kv, g, d), want)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 256, "mma"),
    (torch.float32, 16, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 256, "fma"),
])
def test_flash_route_by_dtype_and_head_dim(dtype, d, want):
    assert fa_k.route(dtype, d) == want
    assert want in fa_k.ROUTES


def test_flash_routes_are_the_c_entry_points_codes():
    """The wrapper hands the C entry point ``ROUTES.index(route)``; the
    entry point's switch reads 0 = fma, 1 = mma, 2 = wgmma, it refuses a
    route whose element type is not the dtype's, and the mma route builds
    only the head dims the wrapper sends it (16 and 256)."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention.cu").read_text()
    entry = src[src.index('extern "C" int flash_attention_fwd('):]
    cases = dict(re.findall(r"case (\d): return ([A-Za-z_0-9(=| ]+)", entry))
    assert cases["0"].startswith("launch_d") and cases["1"].startswith("launch_mma_d")
    assert "flash_attention_sm90" in entry[entry.index("case 2:"):]
    assert "if (dtype != (route == 0 ? 0 : 1)) return -4;" in entry
    mma = src[src.index("int launch_mma_d("):src.index("int launch_mma_d(") + 400]
    built = re.findall(r"case (\d+): return launch_mma<(\d+),", mma)
    assert [d for d, _ in built] == ["16", "256"] and all(a == b for a, b in built)
    assert fa_k.ROUTES == ("fma", "mma", "wgmma")


def test_flash_cpu_path_counts_no_launch():
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    before = dict(fa_k.launches_by_route)
    fa_k.flash_attention(q, q[:, :1], q[:, :1])
    assert fa_k.launches_by_route == before and fa_k.launches == sum(before.values())


@pytest.mark.parametrize("batch,kv,s,sms,want", [
    (8, 8, 1024, 132, 4),        # phi4 serving: 5 wanted, rounded down to a power of two
    (8, 8, 32, 132, 1),          # a short cache: one share
    (1, 1, 32, 132, 1),
    (64, 8, 4096, 132, 1),
    (1, 8, 4096, 132, 8),        # one cluster at most
    (8, 1, 200, 132, 4),         # capped by S / 64 rows
    (4, 8, 1024, 132, 8),
])
def test_decode_num_splits(batch, kv, s, sms, want):
    assert dec_k.num_splits(batch, kv, s, sms) == want


@pytest.mark.parametrize("nsplit,want", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                         (7, 8), (8, 8)])
def test_decode_cluster_size(nsplit, want):
    assert dec_k.cluster_size(nsplit) == want


@pytest.mark.parametrize("nsplit", [0, 9, 16])
def test_decode_cluster_size_rejects_more_than_one_cluster(nsplit):
    with pytest.raises(ValueError, match="splits"):
        dec_k.cluster_size(nsplit)


# K1 on rows that see no column: (b, h, kv, sq, s, d, window, q_offset,
# causal), S <= the Pallas kernel's block_k (512), so that its one kv block
# runs every column for such a row. Each case mixes rows that see some
# columns with rows that see none, or has only the latter.
BLIND_CASES = [
    (1, 4, 2, 64, 64, 16, 8, 60, True),       # rows >= 71 see nothing
    (2, 6, 2, 40, 100, 64, 16, 100, True),    # every row sees nothing
    (1, 4, 4, 48, 96, 32, 24, 96, False),     # non-causal: rows >= 119 see nothing
]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,kv,sq,s,d,window,q_offset,causal", BLIND_CASES)
def test_flash_row_that_sees_no_column_matches_pallas(b, h, kv, sq, s, d, window,
                                                      q_offset, causal, bf16, softcap):
    """The plain version (the CPU path and the card's reference) gives such a
    row what the TPU kernel gives: the mean of V and lse = -1e30 + log S."""
    from repro.kernels.flash_attention import flash_attention as jax_flash
    rng = np.random.default_rng(13)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    out, lse = fa_k.flash_attention(*(to_torch(x, bf16) for x in (q, k, v)),
                                    return_lse=True, **kw)
    p_out, p_lse = jax_flash(*(to_jax(x, bf16) for x in (q, k, v)), return_lse=True,
                             interpret=True, **kw)
    _close(out, p_out, bf16)
    _close(lse, p_lse, bf16)
    blind = fa_k.blind_rows(sq, s, window, q_offset).numpy()
    assert blind.any()
    assert np.all(as_np(lse)[:, :, blind] == np.float32(fa_k.NEG_INF))
    mean_v = np.repeat(as_np(to_torch(v, bf16)).mean(axis=2), h // kv, axis=1)
    _close(as_np(out)[:, :, blind], np.broadcast_to(mean_v[:, :, None, :],
                                                    (b, h, int(blind.sum()), d)), bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_flash_bwd_row_that_sees_no_column_matches_pallas(bf16):
    """With the forward's lse of such a row every pair of it has p = 0, in
    the port's plain backward and in the Pallas kernels alike: its dq is 0
    and it adds nothing to dk and dv."""
    from repro.kernels.flash_attention_bwd import flash_attention_bwd as jax_bwd
    from repro_torch.kernels import flash_attention_bwd as fab_k
    b, h, kv, sq, s, d, window, off = 1, 4, 2, 64, 64, 16, 8, 60
    rng = np.random.default_rng(14)
    q, dout = (rng.standard_normal((b, h, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, kv, s, d)).astype(np.float32) for _ in range(2))
    kw = dict(window=window, q_offset=off)
    tq, tk, tv, tdo = (to_torch(x, bf16) for x in (q, k, v, dout))
    out, lse = fa_k.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    delta = (tdo.float() * out.float()).sum(-1)
    got = fab_k.flash_attention_bwd(tq, tk, tv, tdo, lse, delta, **kw)
    want = jax_bwd(*(to_jax(x, bf16) for x in (q, k, v, dout)), jnp.asarray(as_np(lse)),
                   jnp.asarray(as_np(delta)), interpret=True, **kw)
    for g_, w_ in zip(got, want):
        _close(g_, w_, bf16)
    blind = fa_k.blind_rows(sq, s, window, off)
    assert blind.any() and torch.all(got[0][:, :, blind] == 0)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma"), (torch.bfloat16, 256, "fma"),
    (torch.float32, 16, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 256, "fma"),
])
def test_flash_bwd_route_by_dtype_and_head_dim(dtype, d, want):
    from repro_torch.kernels import flash_attention_bwd as fab_k
    assert fab_k.route(dtype, d) == want
    assert want in fab_k.ROUTES


def test_flash_bwd_routes_are_the_c_entry_points_codes():
    """The wrapper hands the C entry point ``ROUTES.index(route)``; the entry
    point's switch reads 0 = fma, 1 = mma, 2 = wgmma and refuses a route off
    its dtype or head dim; the mma kernels are built for D 16 alone."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention_bwd as fab_k
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    entry = src[src.index('extern "C" int flash_attention_bwd('):]
    assert "if (dtype == 0) return launch_fma_d<float>(a, st);" in entry
    assert "return D == 256 ? launch_fma<__nv_bfloat16, 256" in entry
    assert "case 1: return dtype == 1 && D == 16 ? launch_mma(a, st) : -4;" in entry
    assert ("case 2: return dtype == 1 && (D == 64 || D == 128) ? "
            "flash_attention_bwd_sm90(a, st) : -4;") in entry
    assert "default: return -4;" in entry
    assert re.findall(r"mma_kernel<(\w+), ", src[src.index("int launch_mma("):]) == ["D", "D"]
    assert "constexpr int D = 16," in src[src.index("int launch_mma("):]
    assert fab_k.ROUTES == ("fma", "mma", "wgmma")


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.bfloat16, 16),
                                     (torch.float32, 64)])
def test_flash_bwd_cpu_path_counts_no_launch(dtype, d):
    from repro_torch.kernels import flash_attention_bwd as fab_k
    q = torch.zeros(1, 2, 8, d, dtype=dtype)
    lse = torch.zeros(1, 2, 8)
    before, by_route = fab_k.launches, dict(fab_k.launches_by_route)
    dq, dk, dv = fab_k.flash_attention_bwd(q, q[:, :1], q[:, :1], q, lse, lse)
    assert dq.shape == q.shape and dk.shape == (1, 1, 8, d)
    assert fab_k.launches == before and fab_k.launches_by_route == by_route


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("window,softcap", [(None, 0.0), (16, 20.0)])
def test_flash_bwd_delta_from_out_matches_given_delta(bf16, window, softcap):
    """``delta=None`` with the forward's output computes delta = rowsum(dout *
    out) inside the call (the ``wgmma`` route's dq kernel on the card); on the
    CPU the result equals the call given that delta, bit for bit."""
    from repro_torch.kernels import flash_attention_bwd as fab_k
    b, h, kv, s, d = 1, 4, 2, 48, 16
    rng = np.random.default_rng(15)
    q, dout = (to_torch(rng.standard_normal((b, h, s, d)).astype(np.float32), bf16)
               for _ in range(2))
    k, v = (to_torch(rng.standard_normal((b, kv, s, d)).astype(np.float32), bf16)
            for _ in range(2))
    kw = dict(window=window, softcap=softcap)
    out, lse = fa_k.flash_attention_plain(q, k, v, return_lse=True, **kw)
    given = fab_k.flash_attention_bwd(q, k, v, dout, lse, fab_k.delta_of(dout, out), **kw)
    inside = fab_k.flash_attention_bwd(q, k, v, dout, lse, out=out, **kw)
    for g_, w_ in zip(inside, given):
        assert torch.equal(g_, w_)
    with pytest.raises(ValueError, match="delta"):
        fab_k.flash_attention_bwd(q, k, v, dout, lse)
    with pytest.raises(ValueError, match="delta"):
        fab_k.flash_attention_bwd(q, k, v, dout, lse, out=out[:, :, :1])
