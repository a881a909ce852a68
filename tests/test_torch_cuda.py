"""The port's CUDA kernels on the card, against their plain PyTorch versions.
These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip. Run them on
the card with ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
(``chip_smoke.py`` makes the same comparisons at more shapes, and times them.)
The MLA cases at the end hold no kernel (MLA has none, in either package):
they run deepseek's weight-absorbed decode and smoke engine on the card."""
import pytest
import torch

from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import rwkv6_wkv as wkv_k
from repro_torch.kernels import ssm_scan as ssm_k

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,window,softcap", [
    (2, 8, 2, 256, 64, None, 0.0), (1, 4, 1, 192, 128, 64, 0.0),
    (2, 4, 2, 32, 16, None, 30.0), (1, 8, 4, 128, 256, None, 0.0)])
def test_flash_kernel_vs_plain(device, dtype, b, h, kv, s, d, window, softcap):
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=device)
               .to(dtype).transpose(1, 2) for n in (h, kv, kv))
    before = fa_k.launches
    out, lse = fa_k.flash_attention(q, k, v, window=window, softcap=softcap,
                                    return_lse=True)
    assert fa_k.launches == before + 1
    want, want_lse = fa_k.flash_attention_plain(q, k, v, window=window,
                                                softcap=softcap, return_lse=True)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("contiguous", [False, True], ids=["strided", "contiguous"])
@pytest.mark.parametrize("b,h,kv,sq,s,d,window,softcap,q_offset,causal", [
    (2, 6, 2, 77, 77, 128, None, 0.0, 0, True),       # ragged, G 3
    (2, 4, 4, 200, 200, 64, None, 0.0, 0, True),      # G 1
    (1, 16, 2, 192, 192, 128, None, 0.0, 0, True),    # G 8
    (2, 6, 2, 90, 190, 64, 64, 0.0, 100, True),       # window with q_offset
    (2, 6, 2, 90, 190, 128, 70, 0.0, 100, True),
    (2, 6, 2, 256, 256, 128, None, 30.0, 0, True),    # soft cap
    (1, 6, 2, 100, 77, 128, None, 0.0, 0, False),     # non-causal, ragged
    (2, 24, 8, 512, 512, 128, None, 0.0, 0, True)])   # the serving shape
def test_flash_wgmma_route_vs_plain(device, contiguous, b, h, kv, sq, s, d, window,
                                    softcap, q_offset, causal):
    """bf16 at D 64 / 128 runs on the wgmma + TMA kernel, on the model's
    strided views and on contiguous (B, H, S, D) tensors, lse included."""
    gen = torch.Generator(device=device).manual_seed(7)
    if contiguous:
        q, k, v = (torch.randn((b, n, t, d), generator=gen, device=device).to(torch.bfloat16)
                   for n, t in ((h, sq), (kv, s), (kv, s)))
    else:
        q, k, v = (torch.randn((b, t, n, d), generator=gen, device=device)
                   .to(torch.bfloat16).transpose(1, 2) for n, t in ((h, sq), (kv, s), (kv, s)))
    assert fa_k.route(torch.bfloat16, d) == "wgmma"
    before = dict(fa_k.launches_by_route)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset,
              return_lse=True)
    out, lse = fa_k.flash_attention(q, k, v, **kw)
    assert fa_k.launches_by_route["wgmma"] == before["wgmma"] + 1
    assert fa_k.launches_by_route["mma"] == before["mma"]
    want, want_lse = fa_k.flash_attention_plain(q, k, v, **kw)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)


@pytest.mark.parametrize("contiguous", [False, True], ids=["strided", "contiguous"])
@pytest.mark.parametrize("b,h,kv,sq,s,window,softcap,q_offset,causal", [
    (2, 4, 2, 77, 77, None, 0.0, 0, True),          # ragged Sq and S, G 2
    (1, 4, 4, 200, 200, 64, 0.0, 0, True),          # ragged, window, G 1
    (1, 16, 2, 333, 333, None, 50.0, 0, True),      # G 8, gemma2's soft cap
    (2, 4, 2, 90, 190, 64, 0.0, 100, True),         # window with q_offset
    (2, 4, 2, 64, 200, 32, 0.0, 220, True),         # rows that see no column
    (1, 16, 2, 128, 300, 64, 30.0, 400, True),      # only such rows, soft cap 30
    (1, 4, 2, 100, 300, None, 0.0, 0, False),       # non-causal, Sq < S
    (1, 4, 4, 300, 77, None, 0.0, 0, False),        # non-causal, Sq > S
    (2, 8, 4, 1, 1, None, 0.0, 0, True),            # S 1
    (8, 8, 4, 512, 512, None, 50.0, 0, True)])      # gemma2-2b's served shape
def test_flash_wgmma_route_at_d256_vs_plain(device, contiguous, b, h, kv, sq, s, window,
                                            softcap, q_offset, causal):
    """bf16 at D 256 (gemma2's head dim) runs on the ``wgmma`` + TMA kernel
    (256-thread blocks that issue their own copies), one launch a call and
    every operand read in place, out and lse held against the plain version;
    a row that sees no column gives the mean of V and lse = -1e30 + log S."""
    bf, d = torch.bfloat16, 256
    gen = torch.Generator(device=device).manual_seed(17)
    if contiguous:
        q, k, v = (torch.randn((b, n, t, d), generator=gen, device=device).to(bf)
                   for n, t in ((h, sq), (kv, s), (kv, s)))
    else:
        q, k, v = (torch.randn((b, t, n, d), generator=gen, device=device)
                   .to(bf).transpose(1, 2) for n, t in ((h, sq), (kv, s), (kv, s)))
    assert fa_k.route(bf, d) == "wgmma"
    assert all(fa_k._aligned_view(x) is x for x in (q, k, v))      # no operand copied
    before = dict(fa_k.launches_by_route)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset,
              return_lse=True)
    out, lse = fa_k.flash_attention(q, k, v, **kw)
    assert fa_k.launches_by_route == {**before, "wgmma": before["wgmma"] + 1}
    want, want_lse = fa_k.flash_attention_plain(q, k, v, **kw)
    tol = TOL[bf]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    blind = fa_k.blind_rows(sq, s, window, q_offset, device=device)
    if blind.any():
        assert (lse[:, :, blind] == fa_k.NEG_INF).all()
        mean_v = v.float().mean(dim=2).repeat_interleave(h // kv, dim=1)
        torch.testing.assert_close(out[:, :, blind].float(),
                                   mean_v[:, :, None, :].expand(-1, -1, int(blind.sum()), -1),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,d,rt", [
    (torch.bfloat16, 128, "fma"), (torch.bfloat16, 128, "mma"),
    (torch.bfloat16, 64, "mma"), (torch.float32, 128, "wgmma"),
    (torch.float32, 16, "mma"), (torch.bfloat16, 16, "wgmma"),
    (torch.bfloat16, 256, "mma"), (torch.float32, 256, "wgmma")])
def test_flash_entry_point_refuses_a_route_off_its_dtype_or_head_dim(device, dtype, d, rt):
    """The C entry point returns -4, and launches nothing, for a route that
    does not take the dtype or the head dim (:func:`route` never asks)."""
    q = torch.zeros((1, 2, 8, d), dtype=dtype, device=device)
    out = torch.empty_like(q)
    lse = torch.empty((1, 2, 8), dtype=torch.float32, device=device)
    err = fa_k._kernel_fn()(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), lse.data_ptr(),
        1, 2, 2, 8, 8, d, *q.stride()[:3], *q.stride()[:3], *q.stride()[:3],
        *out.stride()[:3], d ** -0.5, 0.0, 1, 0, 0, int(dtype == torch.bfloat16),
        fa_k.ROUTES.index(rt), torch.cuda.current_stream().cuda_stream)
    assert err == -4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", list(range(1, 9)))
@pytest.mark.parametrize("lengths,splits", [
    ([0, 520, 1], None),           # an all-masked row, a long one, a single valid slot
    ([3, 0, 5], 8),                # fewer valid slots than blocks in the cluster
    ([1000, 7, 0], 3)])            # an explicit, odd split
def test_decode_edge_rows_one_launch(device, dtype, g, lengths, splits):
    """One launch a call; an all-masked row gives what the TPU kernel gives:
    the mean of V, m = -1e30 and l = S."""
    b, kv, s, d = len(lengths), 2, 1024, 128
    gen = torch.Generator(device=device).manual_seed(8)
    q = torch.randn((b, kv, g, d), generator=gen, device=device).to(dtype)
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=device).to(dtype)
            for _ in range(2))
    mask = torch.arange(s, device=device)[None, :] < torch.tensor(lengths, device=device)[:, None]
    before = dec_k.launches
    out, m, l = dec_k.decode_attention(q, k, v, mask, return_stats=True, splits=splits)
    assert dec_k.launches == before + 1
    want = dec_k.decode_attention_plain(q, k, v, mask, return_stats=True)
    for got, ref_ in zip((out, m, l), want):
        atol = TOL[dtype] * min(1.0, ref_.float().abs().max().item())
        torch.testing.assert_close(got.float(), ref_.float(), atol=atol, rtol=TOL[dtype])
    empty = ~mask.any(dim=1)
    assert (m[empty] == dec_k.NEG_INF).all() and (l[empty] == s).all()
    mean_v = v.float().mean(dim=1)[empty][:, :, None, :].expand(-1, -1, g, -1)
    torch.testing.assert_close(out[empty].float(), mean_v, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("masks", ["prefix", "scattered"])
def test_decode_tensor_core_instance_vs_plain(device, g, d, masks):
    """The bf16 instance (q.k and P V on ``mma.sync``) at G 1-8 and D 64,
    128 and 256, over 777 slots (not a multiple of its 64-row stage), one
    launch a call: prefix masks with an all-masked row, or scattered masks;
    soft cap 50 on even G; the splits from 1 to 8 in turn."""
    b, kv, s = 3, 2, 777
    gen = torch.Generator(device=device).manual_seed(13)
    bf = torch.bfloat16
    q = torch.randn((b, kv, g, d), generator=gen, device=device).to(bf)
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=device).to(bf) for _ in range(2))
    if masks == "prefix":
        lengths = torch.tensor([0, 65 * g, s - g], device=device)
        mask = torch.arange(s, device=device)[None, :] < lengths[:, None]
    else:
        mask = torch.rand((b, s), generator=gen, device=device) < 0.3
    cap = 50.0 if g % 2 == 0 else 0.0
    splits = 1 + (g + d // 64) % 8
    assert dec_k.route(bf) == "mma"
    before = dec_k.launches
    out, m, l = dec_k.decode_attention(q, k, v, mask, softcap=cap, return_stats=True,
                                       splits=splits)
    assert dec_k.launches == before + 1
    want = dec_k.decode_attention_plain(q, k, v, mask, softcap=cap, return_stats=True)
    for got, ref_ in zip((out, m, l), want):
        atol = TOL[bf] * min(1.0, ref_.float().abs().max().item())
        torch.testing.assert_close(got.float(), ref_.float(), atol=atol, rtol=TOL[bf])
    empty = ~mask.any(dim=1)
    assert (m[empty] == dec_k.NEG_INF).all() and (l[empty] == s).all()
    assert bool(empty.any()) == (masks == "prefix")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kv,g,s,d", [(8, 8, 3, 1024, 128), (2, 2, 8, 192, 64),
                                        (2, 2, 1, 32, 16), (1, 4, 5, 130, 256)])
def test_decode_kernel_vs_plain(device, dtype, b, kv, g, s, d):
    gen = torch.Generator(device=device).manual_seed(1)
    q = torch.randn((b, kv, g, d), generator=gen, device=device).to(dtype)
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=device).to(dtype)
            for _ in range(2))
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=device)
    mask = torch.arange(s, device=device)[None, :] < lengths[:, None]
    before = dec_k.launches
    got = dec_k.decode_attention(q, k, v, mask, return_stats=True)
    assert dec_k.launches == before + 1
    want = dec_k.decode_attention_plain(q, k, v, mask, return_stats=True)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a.float(), b_.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,dk,dv", [(256, 512, 64, 64), (2, 200, 16, 16),
                                        (3, 1, 64, 64), (2, 37, 24, 40),
                                        (2, 70, 128, 96)])
def test_rwkv6_wkv_kernel_vs_plain(device, dtype, bh, s, dk, dv):
    gen = torch.Generator(device=device).manual_seed(2)
    r, k, w = (torch.randn((bh, s, dk), generator=gen, device=device) for _ in range(3))
    v = torch.randn((bh, s, dv), generator=gen, device=device)
    k, w = k * 0.3, torch.sigmoid(w)
    u = torch.randn((bh, dk), generator=gen, device=device) * 0.1
    r, k, v, w = (t.to(dtype) for t in (r, k, v, w))
    before = wkv_k.launches
    y, st = wkv_k.rwkv6_wkv(r, k, v, w, u)
    assert wkv_k.launches == before + 1
    assert y.dtype == dtype and st.dtype == torch.float32
    want_y, want_st = wkv_k.rwkv6_wkv_plain(r, k, v, w, u)
    tol = 4 * TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(st, want_st, atol=tol, rtol=tol)


BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sq,s,d,window,softcap,q_offset", [
    (2, 24, 8, 512, 512, 128, None, 0.0, 0), (2, 4, 4, 200, 200, 64, None, 0.0, 0),
    (2, 8, 2, 256, 256, 128, 64, 30.0, 0), (2, 4, 2, 90, 190, 128, 70, 0.0, 100),
    (2, 4, 2, 32, 32, 16, None, 0.0, 0), (1, 8, 4, 200, 200, 256, 64, 50.0, 0)])
def test_flash_bwd_kernel_vs_plain(device, dtype, b, h, kv, sq, s, d, window,
                                   softcap, q_offset):
    from repro_torch.kernels import flash_attention_bwd as fab_k
    gen = torch.Generator(device=device).manual_seed(3)
    q, dout = (torch.randn((b, sq, h, d), generator=gen, device=device)
               .to(dtype).transpose(1, 2) for _ in range(2))
    k, v = (torch.randn((b, s, kv, d), generator=gen, device=device)
            .to(dtype).transpose(1, 2) for _ in range(2))
    kw = dict(window=window, softcap=softcap, q_offset=q_offset)
    out, lse = fa_k.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = (dout.float() * out.float()).sum(-1)
    before = fab_k.launches
    got = fab_k.flash_attention_bwd(q, k, v, dout, lse, delta, **kw)
    assert fab_k.launches == before + 1
    want = fab_k.flash_attention_bwd_plain(q, k, v, dout, lse, delta, **kw)
    tol = BWD_TOL[dtype]
    for g_, w_ in zip(got, want):
        assert g_.dtype == dtype
        atol = tol * min(1.0, w_.float().abs().max().item())
        torch.testing.assert_close(g_.float(), w_.float(), atol=atol, rtol=tol)


def test_ops_flash_backward_launches_k5(device):
    """The differentiable ``ops.flash_attention`` runs K1 forward and K5
    backward on the card, and its gradients match the einsum path's."""
    from repro_torch.kernels import flash_attention_bwd as fab_k
    from repro_torch.kernels import ops
    gen = torch.Generator(device=device).manual_seed(4)
    q, k, v = (torch.randn((2, 128, n, 64), generator=gen, device=device,
                           requires_grad=True) for n in (8, 2, 2))
    f0, b0 = fa_k.launches, fab_k.launches
    ops.flash_attention(q, k, v, attn_softcap=20.0).square().sum().backward()
    assert (fa_k.launches - f0, fab_k.launches - b0) == (1, 1)
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    ops.force_ref(True)
    try:
        ops.flash_attention(q, k, v, attn_softcap=20.0).square().sum().backward()
    finally:
        ops.force_ref(False)
    for g_, t in zip(got, (q, k, v)):
        torch.testing.assert_close(g_, t.grad, atol=1e-4, rtol=1e-4)
    # K5 reads the transposed views in place and writes the model's layout
    qt, kt, vt = (t.detach().transpose(1, 2) for t in (q, k, v))
    out, lse = fa_k.flash_attention(qt, kt, vt, return_lse=True)
    copied = fab_k.copied_bytes
    grads = fab_k.flash_attention_bwd(qt, kt, vt, out, lse, (out * out).sum(-1))
    assert fab_k.copied_bytes == copied
    assert all(g_.transpose(1, 2).is_contiguous() for g_ in grads)


@pytest.mark.parametrize("extreme", [False, True], ids=["softplus-dt", "extreme-dt*a"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,d_in,n,routes", [
    (2, 512, 1024, 16, ("tma", "tma")), (2, 32, 128, 8, ("tma", "tma")),
    (2, 200, 256, 16, ("tma", "tma")), (3, 37, 1000, 5, ("simple", "simple")),
    (4, 2, 384, 16, ("tma", "tma")), (1, 1, 64, 3, ("simple", "simple")),
    (2, 50, 130, 16, ("simple", "simple")), (2, 70, 132, 12, ("tma", "simple")),
    (3, 9, 1000, 4, ("tma", "tma"))])
def test_ssm_scan_kernel_vs_plain(device, dtype, b, s, d_in, n, routes, extreme):
    """Both routes against the plain version; ``extreme`` draws dt up to 50
    and a in (-20, -1], so that dt * a reaches about -1000 (the clamp of the
    FMA-pipe exp). ``routes``: the route in (fp32, bf16). (a near 0 as well
    makes a long-memory state whose fp32 rounding the plain version shows
    too: ``test_ssm_scan_kernel_at_long_memory_as_exact_as_plain``.)"""
    rt = routes[dtype == torch.bfloat16]
    assert ssm_k.route(dtype, d_in, n) == rt
    gen = torch.Generator(device=device).manual_seed(5)
    u = torch.randn((b, s, d_in), generator=gen, device=device).to(dtype)
    if extreme:
        dt = (torch.rand((b, s, d_in), generator=gen, device=device) * 50).to(dtype)
        a = -1 - torch.rand((d_in, n), generator=gen, device=device) * 19
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((b, s, d_in), generator=gen, device=device) * 0.5).to(dtype)
        a = -torch.exp(torch.randn((d_in, n), generator=gen, device=device) * 0.3)
    bm, cm = (torch.randn((b, s, n), generator=gen, device=device) for _ in range(2))
    d_skip = torch.ones(d_in, device=device)
    before, on_route = ssm_k.launches, ssm_k.launches_by_route[rt]
    y, h = ssm_k.ssm_scan(u, dt, bm, cm, a, d_skip)
    assert ssm_k.launches == before + 1 and ssm_k.launches_by_route[rt] == on_route + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    want_y, want_h = ssm_k.ssm_scan_plain(u, dt, bm, cm, a, d_skip)
    tol = 4 * TOL[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, want_h, atol=tol, rtol=tol)


def test_ssm_scan_tma_takes_views_off_16_bytes(device):
    """Operands that start off a 16-byte boundary (contiguous views one
    element into a buffer) stay on the tma route, through aligned copies,
    and match the plain version."""
    b, s, d_in, n = 2, 40, 256, 16
    gen = torch.Generator(device=device).manual_seed(7)

    def view(shape, draw, dtype=torch.float32):
        numel = shape[0] * shape[1] * (shape[2] if len(shape) > 2 else 1)
        buf = draw((numel + 1,), generator=gen, device=device).to(dtype)
        return buf[1:].view(shape)

    u = view((b, s, d_in), torch.randn, torch.bfloat16)
    dt = view((b, s, d_in), torch.rand, torch.bfloat16)
    bm, cm = view((b, s, n), torch.randn), view((b, s, n), torch.randn)
    a = view((d_in, n), lambda shape, **kw: -torch.rand(shape, **kw))
    ins = (u, dt, bm, cm, a, torch.ones(d_in, device=device))
    assert all(t.data_ptr() % 16 for t in ins[:5]) and ssm_k.route(u.dtype, d_in, n) == "tma"
    before = ssm_k.launches_by_route["tma"]
    y, h = ssm_k.ssm_scan(*ins)
    assert ssm_k.launches_by_route["tma"] == before + 1
    want_y, want_h = ssm_k.ssm_scan_plain(*ins)
    tol = 4 * TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, want_h, atol=tol, rtol=tol)


def _ssm_scan_fp64(u, dt, bm, cm, a, d_skip):
    """The scan in float64: the yardstick of the fp32 computations."""
    b, s, d_in = u.shape
    u, dt, bm, cm, a, d_skip = (t.double() for t in (u, dt, bm, cm, a, d_skip))
    h = torch.zeros((b, d_in, a.shape[1]), dtype=torch.float64, device=u.device)
    y = torch.empty((b, s, d_in), dtype=torch.float64, device=u.device)
    for t in range(s):
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * u[:, t])[:, :, None] * bm[:, t, None, :])
        y[:, t] = (h * cm[:, t, None, :]).sum(-1)
    return y + u * d_skip, h


def test_ssm_scan_kernel_at_long_memory_as_exact_as_plain(device):
    """fp32, 512 steps, dt up to 50 and a in (-20, 0]: where a is near 0 the
    state sums hundreds of steps into values of some hundreds and y cancels
    them, so the fp32 versions differ from one another by more than the
    fp32 tolerance. The tma route is held to be no further from a float64
    scan than the plain version is."""
    b, s, d_in, n, rt = 2, 512, 1024, 16, "tma"
    assert ssm_k.route(torch.float32, d_in, n) == rt
    gen = torch.Generator(device=device).manual_seed(5)
    u = torch.randn((b, s, d_in), generator=gen, device=device)
    dt = torch.rand((b, s, d_in), generator=gen, device=device) * 50
    a = -torch.rand((d_in, n), generator=gen, device=device) * 20
    bm, cm = (torch.randn((b, s, n), generator=gen, device=device) for _ in range(2))
    ins = (u, dt, bm, cm, a, torch.ones(d_in, device=device))
    before = ssm_k.launches_by_route[rt]
    got = ssm_k.ssm_scan(*ins)
    assert ssm_k.launches_by_route[rt] == before + 1
    plain = ssm_k.ssm_scan_plain(*ins)
    exact = _ssm_scan_fp64(*ins)
    for g, p, e in zip(got, plain, exact):
        assert torch.isfinite(g).all()
        assert (g.double() - e).abs().max() <= (p.double() - e).abs().max()


def test_jamba_smoke_kernels_on_vs_off(device):
    """The jamba smoke model in fp32 on the card: prefill logits with the
    kernels (K1 and K3) against the einsum and loop path, and one decode
    step (K2) after it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = get_smoke_config("jamba-1.5-large-398b").scaled(dtype="float32")
    params = init_params(cfg, 0, device=device)
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator(device=device).manual_seed(6),
                         device=device)
    out = {}
    for on in (True, False):
        eng = Engine(cfg, params, EngineConfig(max_len=32, use_kernels=on), device=device)
        s0 = ssm_k.launches
        logits, caches, lengths = eng.prefill(toks)
        step, _, _ = eng.decode(caches, lengths, logits.argmax(-1))
        out[on] = (logits, step, ssm_k.launches - s0)
    assert out[True][2] == 7 and out[False][2] == 0
    for a_, b_ in zip(out[True][:2], out[False][:2]):
        torch.testing.assert_close(a_, b_, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("dtype,d,rt", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 64, "fma"), (torch.float32, 128, "fma")])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non-causal"])
def test_flash_row_that_sees_no_column_on_every_route(device, dtype, d, rt, causal):
    """Rows past S - 1 + window see no column: out is the mean of V and lse
    = -1e30 + log S, as in the plain version and the TPU kernel; the rows
    beside them are unchanged."""
    b, h, kv, sq, s, window, q_offset = 2, 6, 2, 64, 100, 16, 100
    gen = torch.Generator(device=device).manual_seed(9)
    q, k, v = (torch.randn((b, t, n, d), generator=gen, device=device)
               .to(dtype).transpose(1, 2) for n, t in ((h, sq), (kv, s), (kv, s)))
    assert fa_k.route(dtype, d) == rt
    before = dict(fa_k.launches_by_route)
    kw = dict(causal=causal, window=window, q_offset=q_offset, return_lse=True)
    out, lse = fa_k.flash_attention(q, k, v, **kw)
    assert fa_k.launches_by_route[rt] == before[rt] + 1
    want, want_lse = fa_k.flash_attention_plain(q, k, v, **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=tol)
    blind = fa_k.blind_rows(sq, s, window, q_offset, device=device)
    assert blind.any() and not blind.all()
    assert (lse[:, :, blind] == fa_k.NEG_INF).all()
    mean_v = v.float().mean(dim=2).repeat_interleave(h // kv, dim=1)
    torch.testing.assert_close(out[:, :, blind].float(),
                               mean_v[:, :, None, :].expand(-1, -1, int(blind.sum()), -1),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("contiguous", [False, True], ids=["strided", "contiguous"])
@pytest.mark.parametrize("b,h,kv,sq,s,d,window,softcap,q_offset,causal", [
    (2, 24, 8, 512, 512, 128, None, 0.0, 0, True),    # the training shape
    (1, 8, 1, 200, 200, 64, None, 0.0, 0, True),      # ragged, G 8
    (2, 6, 2, 200, 200, 128, None, 0.0, 0, True),     # ragged, G 3
    (2, 6, 2, 256, 256, 64, 64, 30.0, 0, True),       # window with soft cap
    (2, 6, 2, 256, 256, 128, 64, 30.0, 0, True),
    (2, 4, 4, 90, 190, 128, 70, 0.0, 100, True),      # q_offset with window, G 1
    (1, 6, 2, 100, 300, 128, None, 0.0, 0, False),    # non-causal
    (2, 6, 2, 64, 200, 128, 32, 0.0, 220, True)])     # rows that see no column
def test_flash_bwd_wgmma_route_vs_plain(device, contiguous, b, h, kv, sq, s, d, window,
                                        softcap, q_offset, causal):
    """bf16 at D 64 / 128 runs on the wgmma + TMA kernels, on the model's
    strided views and on contiguous tensors, with delta given and with delta
    computed inside from the forward's output."""
    from repro_torch.kernels import flash_attention_bwd as fab_k
    gen = torch.Generator(device=device).manual_seed(10)
    bf = torch.bfloat16
    if contiguous:
        q, dout = (torch.randn((b, h, sq, d), generator=gen, device=device).to(bf)
                   for _ in range(2))
        k, v = (torch.randn((b, kv, s, d), generator=gen, device=device).to(bf)
                for _ in range(2))
    else:
        q, dout = (torch.randn((b, sq, h, d), generator=gen, device=device).to(bf)
                   .transpose(1, 2) for _ in range(2))
        k, v = (torch.randn((b, s, kv, d), generator=gen, device=device).to(bf)
                .transpose(1, 2) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    out, lse = fa_k.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fab_k.delta_of(dout, out)
    assert fab_k.route(bf, d) == "wgmma"
    before = dict(fab_k.launches_by_route)
    given = fab_k.flash_attention_bwd(q, k, v, dout, lse, delta, **kw)
    inside = fab_k.flash_attention_bwd(q, k, v, dout, lse, out=out, **kw)
    assert fab_k.launches_by_route["wgmma"] == before["wgmma"] + 2
    assert sum(fab_k.launches_by_route.values()) == sum(before.values()) + 2
    want = fab_k.flash_attention_bwd_plain(q, k, v, dout, lse, delta, **kw)
    tol = BWD_TOL[bf]
    for got in (given, inside):
        for g_, w_, ref_in in zip(got, want, (q, k, v)):
            assert g_.dtype == bf and g_.shape == ref_in.shape
            atol = tol * min(1.0, w_.float().abs().max().item())
            torch.testing.assert_close(g_.float(), w_.float(), atol=atol, rtol=tol)


@pytest.mark.parametrize("contiguous", [False, True], ids=["strided", "contiguous"])
@pytest.mark.parametrize("b,h,kv,sq,s,window,softcap,q_offset,causal", [
    (1, 8, 4, 256, 256, None, 50.0, 0, True),      # gemma2-2b's soft cap, G 2
    (1, 8, 4, 200, 200, 64, 0.0, 0, True),         # window 64, ragged S
    (2, 4, 4, 192, 192, None, 50.0, 0, True),      # G 1
    (1, 16, 2, 256, 256, 64, 50.0, 0, True),       # G 8, window with soft cap
    (2, 4, 2, 90, 190, 70, 0.0, 100, True),        # window with q_offset
    (1, 4, 2, 100, 300, None, 0.0, 0, False),      # non-causal
    (2, 4, 2, 64, 200, 32, 0.0, 220, True),        # rows that see no column
    (1, 8, 4, 333, 333, None, 50.0, 0, True)])     # a batch of one, ragged: odd dout stride
def test_flash_bwd_wgmma_route_at_d256_vs_plain(device, contiguous, b, h, kv, sq, s, window,
                                                softcap, q_offset, causal):
    """bf16 at D 256 (gemma2-2b's head dim) runs on the ``wgmma`` + TMA
    kernels, on the model's strided views and on contiguous tensors, with
    delta given and with delta computed from the forward's output; a row
    that sees no column gives dq = 0. At a batch of one, dout's batch stride
    is set to 1 element (as autograd hands it over) and read in place."""
    from repro_torch.kernels import flash_attention_bwd as fab_k
    gen = torch.Generator(device=device).manual_seed(11)
    bf, d = torch.bfloat16, 256
    if contiguous:
        q, dout = (torch.randn((b, h, sq, d), generator=gen, device=device).to(bf)
                   for _ in range(2))
        k, v = (torch.randn((b, kv, s, d), generator=gen, device=device).to(bf)
                for _ in range(2))
    else:
        q, dout = (torch.randn((b, sq, h, d), generator=gen, device=device).to(bf)
                   .transpose(1, 2) for _ in range(2))
        k, v = (torch.randn((b, s, kv, d), generator=gen, device=device).to(bf)
                .transpose(1, 2) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    out, lse = fa_k.flash_attention_plain(q, k, v, return_lse=True, **kw)
    delta = fab_k.delta_of(dout, out)
    if b == 1:
        dout = dout.as_strided(dout.shape, (1,) + dout.stride()[1:])
    assert fab_k.route(bf, d) == "wgmma"
    before, copied = dict(fab_k.launches_by_route), fab_k.copied_bytes
    given = fab_k.flash_attention_bwd(q, k, v, dout, lse, delta, **kw)
    inside = fab_k.flash_attention_bwd(q, k, v, dout, lse, out=out, **kw)
    assert fab_k.copied_bytes == copied
    assert fab_k.launches_by_route["wgmma"] == before["wgmma"] + 2
    assert sum(fab_k.launches_by_route.values()) == sum(before.values()) + 2
    want = fab_k.flash_attention_bwd_plain(q, k, v, dout, lse, delta, **kw)
    tol = BWD_TOL[bf]
    for got in (given, inside):
        for g_, w_, ref_in in zip(got, want, (q, k, v)):
            assert g_.dtype == bf and g_.shape == ref_in.shape
            atol = tol * min(1.0, w_.float().abs().max().item())
            torch.testing.assert_close(g_.float(), w_.float(), atol=atol, rtol=tol)
    blind = fa_k.blind_rows(sq, s, window, q_offset, device=device)
    assert bool(blind.any()) == (q_offset == 220)
    assert (given[0][:, :, blind] == 0).all()


@pytest.mark.parametrize("dtype,d,rt,from_out", [
    (torch.bfloat16, 128, "fma", 0), (torch.bfloat16, 128, "mma", 0),
    (torch.bfloat16, 64, "mma", 0), (torch.float32, 128, "wgmma", 0),
    (torch.float32, 16, "mma", 0), (torch.bfloat16, 16, "wgmma", 0),
    (torch.bfloat16, 256, "mma", 0), (torch.bfloat16, 256, "fma", 0),
    (torch.bfloat16, 64, "fma", 0),
    (torch.bfloat16, 16, "mma", 1), (torch.float32, 64, "fma", 1)])
def test_flash_bwd_entry_point_refuses_a_route_off_its_dtype_or_head_dim(device, dtype, d,
                                                                         rt, from_out):
    """The C entry point returns -4, and launches nothing, for a route that
    does not take the dtype or the head dim, or for delta from out off the
    wgmma route (:func:`route` never asks)."""
    from repro_torch.kernels import flash_attention_bwd as fab_k
    q = torch.zeros((1, 2, 8, d), dtype=dtype, device=device)
    g = torch.empty_like(q)
    lse = torch.zeros((1, 2, 8), dtype=torch.float32, device=device)
    st = q.stride()[:3]
    err = fab_k._kernel_fn()(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), q.data_ptr(), lse.data_ptr(), lse.data_ptr(),
        g.data_ptr(), g.data_ptr(), g.data_ptr(), q.data_ptr(), 1, 2, 2, 8, 8, d,
        *st, *st, *st, *st, *st, *st, *st, *st, d ** -0.5, 0.0, 1, 0, 0, from_out,
        int(dtype == torch.bfloat16), fab_k.ROUTES.index(rt),
        torch.cuda.current_stream().cuda_stream)
    assert err == -4


@pytest.mark.parametrize("view", ["dense", "sliced", "transposed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,dk,dv", [(8, 512, 32, 64, 64), (2, 200, 4, 64, 64),
                                         (2, 1, 4, 64, 64), (2, 70, 3, 128, 96),
                                         (2, 37, 3, 24, 40)])
def test_rwkv6_wkv_model_kernel_vs_plain(device, view, dtype, b, s, h, dk, dv):
    """The model-layout entry on (B, S, H, D) views (r, k, v in ``dtype``, w and
    u fp32) against its plain version, and bit for bit against the folded
    entry on fp32 copies of the same values."""
    gen = torch.Generator(device=device).manual_seed(11)

    def make(d, dt, scale=1.0, squash=False):
        shape = {"dense": (b, s, h, d), "sliced": (b, s, h, d + 8),
                 "transposed": (b, h, s, d)}[view]
        x = torch.randn(shape, generator=gen, device=device) * scale
        x = (torch.sigmoid(x) if squash else x).to(dt)
        return x[..., :d] if view == "sliced" else (x.transpose(1, 2) if view == "transposed" else x)
    r, k, v = make(dk, dtype), make(dk, dtype, 0.3), make(dv, dtype)
    w = make(dk, torch.float32, squash=True)
    u = torch.randn((h, dk), generator=gen, device=device) * 0.1
    before = wkv_k.launches
    y, st = wkv_k.rwkv6_wkv_model(r, k, v, w, u)
    assert wkv_k.launches == before + 1
    assert y.shape == (b, s, h, dv) and y.dtype == torch.float32 and st.shape == (b, h, dk, dv)
    want_y, want_st = wkv_k.rwkv6_wkv_model_plain(r, k, v, w, u)
    tol = 4 * TOL[dtype]
    torch.testing.assert_close(y, want_y, atol=tol, rtol=tol)
    torch.testing.assert_close(st, want_st, atol=tol, rtol=tol)

    def fold(t):
        return t.float().transpose(1, 2).reshape(b * h, s, t.shape[-1]).contiguous()
    fy, fst = wkv_k.rwkv6_wkv(fold(r), fold(k), fold(v), fold(w), u.repeat(b, 1))
    assert torch.equal(fy.reshape(b, h, s, dv).transpose(1, 2), y)
    assert torch.equal(fst.reshape(b, h, dk, dv), st)


def test_mla_absorbed_decode_vs_dense_on_the_card(device):
    """MLA at deepseek-v3's head and latent widths (16 of its 128 heads), fp32
    on the card: prefill S-1 tokens, pad the cache, one absorbed decode step,
    against the dense path over S tokens at the last position."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    cfg = get_config("deepseek-v3-671b").scaled(d_model=1024, num_heads=16,
                                                dtype="float32")
    gen = torch.Generator(device=device).manual_seed(3)
    p = {}
    for name, spec in attn.mla_param_specs(cfg).items():
        t = torch.randn(spec.shape, generator=gen, device=device)
        p[name] = 1.0 + 0.1 * t if spec.init == "ones" else t / spec.shape[0] ** 0.5
    b, s = 2, 130
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=device)
    pos = torch.arange(s, device=device)[None]
    full, _ = attn.mla_attention_dense(cfg, p, x, pos)
    _, raw = attn.mla_attention_dense(cfg, p, x[:, :-1], pos[:, :-1])
    cache = attn.init_mla_cache(cfg, b, 256, torch.float32, device=device)
    cache.latent[:, :s - 1] = raw.latent
    cache.k_rope[:, :s - 1] = raw.k_rope
    step, _ = attn.mla_attention_decode(cfg, p, x[:, -1:], cache,
                                        torch.full((b,), s - 1, device=device))
    scale = max(1.0, full[:, -1].abs().max().item())
    torch.testing.assert_close(step[:, 0], full[:, -1], atol=5e-4 * scale, rtol=0)


def test_deepseek_smoke_on_the_card_vs_cpu(device):
    """The deepseek smoke engine in fp32: prefill and three decode steps on
    the card against the same weights on the CPU, and the MTP loss."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = get_smoke_config("deepseek-v3-671b").scaled(dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(4))
    steps, fed = {}, []          # the card is fed the CPU's greedy tokens
    for dev in ("cpu", device):
        tree = _tree_to(params, dev)
        eng = Engine(cfg, tree, EngineConfig(max_len=32), device=dev)
        logits, caches, lengths = eng.prefill(toks)
        out = [logits]
        for i in range(3):
            if dev == "cpu":
                fed.append(logits.argmax(-1))
            logits, caches, lengths = eng.decode(caches, lengths, fed[i])
            out.append(logits)
        with torch.no_grad():
            _, metrics = model_lib.loss_fn(cfg, tree, {"tokens": toks.to(dev)})
        steps[str(dev)] = [o.cpu() for o in out] + [metrics["mtp"].cpu()]
    for a_, b_ in zip(steps["cpu"], steps[str(device)]):
        torch.testing.assert_close(b_, a_, atol=5e-4, rtol=5e-4)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# configurations on the decode graph's route: small ones, phi4's GQA at D 64,
# gemma2's local ring (window 16, passed by the prompt) at D 128, a
# mixtral-shaped GQA + MoE (8 experts, top-2, window 32) and deepseek's smoke
# MLA + MoE (a dense layer, then 3 of top-2 over 8 experts); and phi4, mixtral
# and deepseek at every published width, 2 layers deep (cuBLAS picks its GEMMs
# by the widths and the batch, so the served steps' GEMMs run here), deepseek
# as a dense layer and a MoE layer that holds 8 of the router's 256 experts, as
# the benchmark's stage does. GQA runs in bf16 and is held bit for bit;
# deepseek in fp32, since its top-8 combine adds by atomics in no fixed order
_DEEPSEEK_EP = dict(num_experts=8, num_routed=256)
GRAPH_CASES = {
    "phi4-mini-3.8b": dict(num_layers=2, d_model=256, num_heads=6, num_kv_heads=2,
                           head_dim=64, d_ff=512, vocab_size=512),
    "gemma2-2b": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
                      head_dim=128, d_ff=512, vocab_size=512, sliding_window=16),
    "phi4-mini-3.8b-full": dict(num_layers=2),
    "mixtral-8x7b": dict(num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
                         head_dim=64, vocab_size=512, sliding_window=32),
    "mixtral-8x7b-full": dict(num_layers=2),
    "deepseek-v3-671b": dict(dtype="float32"),
    "deepseek-v3-671b-full": dict(num_layers=2, num_dense_layers=1, mtp_depth=0,
                                  dtype="float32", moe=_DEEPSEEK_EP),
}
# the reference's fp32 tolerance on the logits of a case that is not held bit for bit
GRAPH_FP32_ATOL = 5e-5


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_decode_graph_replays_equal_the_eager_loop(device, case):
    """Greedy steps replayed from CUDA graphs against the engine's per-step
    API (``prefill`` + ``decode`` on fresh cache trees) on the same weights:
    tokens equal and logits equal (GQA, bf16) or within the fp32 tolerance
    (deepseek) at batch sizes 3, 8 and 1 bound to one cache (stale slots
    past the later, shorter prompts), the MoE pairs equal by phase, no
    capture at a warmed batch size, K1 and K2 counted by the launches each
    replay captured (none for MLA), and so the kernel calls that
    ``chip_smoke.recording_calls`` records, and the caches' and graphs'
    memory back once the engine goes."""
    import collections
    import dataclasses
    import os
    import runpy
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.engine import Engine, EngineConfig
    arch = case.removesuffix("-full")
    base_cfg = get_config(arch) if case.endswith("-full") else get_smoke_config(arch)
    over = {"dtype": "bfloat16", **GRAPH_CASES[case]}
    if "moe" in over:
        over["moe"] = dataclasses.replace(base_cfg.moe, **over["moe"])
    cfg = base_cfg.scaled(**over)
    exact = cfg.dtype == "bfloat16"
    params = init_params(cfg, 0, dtype=getattr(torch, cfg.dtype), device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ecfg = EngineConfig(max_len=48)
    graphed = Engine(cfg, params, ecfg, device=device)
    assert graphed.runner.captured
    plan = [(sl, g.n_units) for g in tfm.layer_plan(cfg) for sl in g.pattern]
    attn_layers = sum(u for sl, u in plan if sl.mixer == "gqa")   # K1 and K2: none in MLA
    moe_layers = sum(u for sl, u in plan if sl.mlp == "moe")
    gen = torch.Generator().manual_seed(3)
    steps = 6
    for n, plen in ((3, 30), (8, 24), (1, 20), (3, 18)):
        toks = torch.randint(1, cfg.vocab_size, (n, plen), generator=gen)
        pairs0 = moe.pair_counts(device).clone()
        with torch.inference_mode():
            logits, caches, lengths = graphed.prefill(toks)
            pairs1 = moe.pair_counts(device).clone()
            want = [logits]
            for _ in range(steps):
                logits, caches, lengths = graphed.decode(caches, lengths, logits.argmax(-1))
                want.append(logits.clone())
            pairs = {"prefill": (pairs1 - pairs0).tolist(),
                     "decode": (moe.pair_counts(device) - pairs1).tolist()}
            ref = torch.stack([w.argmax(-1) for w in want[:steps]], 1).cpu().numpy()
            r = graphed.runner
            st = r.step_for(n)
            logits, _, lengths = graphed.prefill(toks, out=st.caches)
            r.start(st, logits, lengths)
            got = []
            for _ in range(steps):
                got.append(r.replay(st).clone())
        for i, (w, x) in enumerate(zip(want[1:], got)):
            assert torch.equal(w.argmax(-1), x.argmax(-1)), (n, plen, i)
            err = (w - x).abs().max().item()
            assert err == 0 if exact else err <= GRAPH_FP32_ATOL, (n, plen, i, err)
        k1, k2 = fa_k.launches, dec_k.launches
        out = graphed.generate(toks, steps)
        assert graphed.last_stats["graph_captures"] == 0           # warmed by the above
        assert graphed.last_stats["graph_steps"] == steps
        assert sum(graphed.last_stats["syncs"].values()) == 3
        assert (fa_k.launches - k1, dec_k.launches - k2) == (attn_layers, attn_layers * steps)
        assert (out == ref).all()
        if cfg.moe is not None:     # the replays count their pairs as the per-step API
            got_pairs = graphed.last_stats["moe_pairs"]
            for phase in ("prefill", "decode"):
                assert [got_pairs[phase][k] for k in ("routed", "held", "dropped")] == \
                    pairs[phase], phase
            assert got_pairs["decode"]["routed"] == (
                n * cfg.moe.top_k * moe_layers * steps)
    assert sorted(graphed.runner.steps) == [1, 3, 8]
    del graphed, r, st, logits, caches, lengths, want, got, w, x
    torch.cuda.empty_cache()
    # what stays is cuBLAS's workspace for the capture stream, once a process
    assert 0 <= torch.cuda.memory_allocated() - base <= 64 << 20
    base = torch.cuda.memory_allocated()
    # an engine built after the last graph went captures into a new pool, and
    # its cache, graphs and pool go with it
    again = Engine(cfg, params, ecfg, device=device)
    cs = runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                     "chip_smoke.py"), run_name="chip_smoke")
    calls = collections.Counter()
    with cs["recording_calls"](calls):
        got = again.generate(toks, steps)
    assert (got == ref).all()
    assert again.last_stats["graph_captures"] == 1
    per_entry = collections.Counter()
    for (name, _, _), n in calls.items():
        per_entry[name.replace("_model", "")] += n
    assert +per_entry == +collections.Counter({"flash_attention": attn_layers,
                                               "decode_attention": attn_layers * steps})
    del again
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() == base


def _ep_router_config():
    """deepseek's smoke widths (``d_model`` 256) with its published router:
    sigmoid scores over 256 experts in 8 groups, 4 kept, top-8, of which
    the layer holds 8 (one EP32 rank's share), one MoE layer."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    m = dataclasses.replace(get_config("deepseek-v3-671b").moe, num_experts=8,
                            num_routed=256, d_ff_expert=64)
    return get_smoke_config("deepseek-v3-671b").scaled(d_model=256, moe=m,
                                                        num_dense_layers=0, num_layers=1)


@pytest.mark.parametrize("arch,b,s", [("mixtral-8x7b", 8, 1), ("mixtral-8x7b", 8, 96),
                                      ("deepseek-v3-671b", 8, 1),
                                      ("deepseek-v3-671b", 8, 96)],
                         ids=["decode", "prefill", "deepseek-decode", "deepseek-prefill"])
def test_moe_apply_waits_for_no_host_sync(device, arch, b, s):
    """A mixtral-shaped MoE layer (8 experts, top-2, bf16), and one behind
    deepseek's sigmoid group-limited router (top-8 of 256, 8 held), at a
    decode size and at a prefill size with drops at capacity makes no call
    that synchronises with the host, and counts on the device the pairs that
    its own routing gives: the held ones, and those past an expert's
    capacity dropped."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models import moe
    if arch == "deepseek-v3-671b":
        cfg = _ep_router_config()
    else:
        m = dataclasses.replace(get_smoke_config(arch).moe, num_experts=8)
        cfg = get_smoke_config(arch).scaled(d_model=256, moe=m)
    p = init_params(cfg, 0, device="cpu")["layers"]["sub0"]["moe"]
    p = {k: v[0].to(device, torch.bfloat16) for k, v in p.items()}
    x = torch.randn(b, s, cfg.d_model, generator=torch.Generator().manual_seed(1))
    x[..., 0] += 4.0            # crowd the tokens onto a few experts
    x = x.to(device, torch.bfloat16)
    moe.moe_apply(cfg, p, x)      # loads cuBLAS and the sort outside the check
    before = moe.pair_counts(device).clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe.moe_apply(cfg, p, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    routed, held, dropped = (moe.pair_counts(device) - before).tolist()
    m, x2 = cfg.moe, x.reshape(b * s, -1)
    if m.scoring == "sigmoid":
        _, idx = moe.route_grouped(cfg, x2.float() @ p["w_router"].float(), p["router_bias"])
    else:
        _, idx = moe.route_topk(cfg, x2 @ p["w_router"])
    per_expert = torch.bincount(idx.flatten(), minlength=m.router_width)[:m.num_experts].cpu()
    c = moe.capacity(b * s, m.router_width, m.top_k)
    assert routed == b * s * m.top_k and held == int(per_expert.sum())
    assert dropped == int((per_expert - c).clamp_min(0).sum()) and (dropped > 0) == (s > 1)
    assert out.shape == x.shape and torch.isfinite(out).all()


def test_yarn_table_is_never_first_built_inside_a_capture(device):
    """A capture records kernels without running them: YaRN's table, cached
    for the process, raises there when it is not built yet, and is built
    eagerly afterwards."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    rs = get_config("deepseek-v3-671b").rope_scaling
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="outside a CUDA graph capture"):
        with torch.cuda.graph(graph):
            layers.yarn_freqs(64, 12345.0, rs, device)
    got = layers.yarn_freqs(64, 12345.0, rs, device)
    torch.testing.assert_close(got.cpu(), layers.yarn_freqs(64, 12345.0, rs, torch.device("cpu")),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("dense_layers", [1, 0], ids=["dense-prelude", "moe-only"])
def test_deepseek_decode_step_waits_for_no_host_sync(device, dense_layers):
    """One deepseek decode step (``model.decode_step`` on the views of the
    engine's step of 8 rows, after its prefill into them), with the published
    router of 256 experts over 8 held, makes no call that synchronises with
    the host: MLA's absorbed decode, YaRN's cached table, the router and the
    dispatch, with and without the dense prelude."""
    from repro_torch.models import init_params
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg = _ep_router_config().scaled(num_layers=3, num_dense_layers=dense_layers)
    params = init_params(cfg, 0, dtype=torch.bfloat16, device=device)
    eng = Engine(cfg, params, EngineConfig(max_len=40), device=device)
    toks = torch.randint(1, cfg.vocab_size, (8, 24), generator=torch.Generator().manual_seed(2))
    st = eng.runner.step_for(8)
    with torch.inference_mode():
        logits, caches, lengths = eng.prefill(toks, out=st.caches)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, caches, lengths = model_lib.decode_step(cfg, params, st.caches, lengths,
                                                            tok, use_kernels=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert caches is st.caches and lengths.tolist() == [25] * 8
    assert torch.isfinite(logits).all()


# ----------------------------------------------------------------------
# rwkv6-1.6b as published (Finch) at every width, 2 of its 24 layers, against
# the plain reference ``torch_ref_rwkv6`` on the card
RWKV_PROMPT, RWKV_STEPS = 256, 6
# the served tokens' gap (the reference's best logit less its logit of the
# token the program served) of the bf16 program through 2 layers
RWKV_BF16_GAP = 0.2


def _rwkv_case(dtype, seed):
    """The published configuration cut to 2 layers, weights from the port's
    init with noise on every leaf it makes constant (norm scales and biases,
    the mixes, the decay base, the bonus), so that each part weighs."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("rwkv6-1.6b").scaled(num_layers=2, dtype=dtype)
    params = init_params(cfg, seed, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)

    def perturb(tree):
        for v in tree.values():
            if isinstance(v, dict):
                perturb(v)
            elif v.std() == 0:
                v.add_(0.1 * torch.randn(v.shape, generator=gen, device="cuda"))
    perturb(params)
    if dtype == "bfloat16":
        params = _tree_cast(params, torch.bfloat16)
    toks = torch.randint(1, cfg.vocab_size, (4, RWKV_PROMPT + RWKV_STEPS),
                         generator=torch.Generator().manual_seed(seed + 2))
    return cfg, params, toks


def _tree_cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _tree_cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _rwkv_reference(cfg, params, toks):
    import dataclasses

    import torch_ref_rwkv6
    return torch_ref_rwkv6.forward(dataclasses.asdict(cfg), params, toks.cuda())


def test_rwkv6_published_prefill_and_decode_vs_reference_fp32(device):
    """K4's prefill (fp32) and the eager one-step decode through the carried
    state against the reference's full forward, at positions PROMPT - 1 ..
    PROMPT + STEPS - 2; fp32 both, the recurrence's tolerance 5e-5 x 4."""
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, params, toks = _rwkv_case("float32", 11)
    eng = Engine(cfg, params, EngineConfig(max_len=RWKV_PROMPT + RWKV_STEPS), device=device)
    before = wkv_k.launches
    with torch.inference_mode():
        logits, caches, lengths = eng.prefill(toks[:, :RWKV_PROMPT])
        got = [logits]
        for i in range(RWKV_STEPS - 1):
            logits, caches, lengths = eng.decode(caches, lengths,
                                                 toks[:, RWKV_PROMPT + i].to(device))
            got.append(logits)
    assert wkv_k.launches == before + cfg.num_layers          # one K4 a layer, in prefill
    want = _rwkv_reference(cfg, params, toks)[:, RWKV_PROMPT - 1:RWKV_PROMPT + RWKV_STEPS - 1]
    got = torch.stack(got, 1)
    print(f"rwkv6 fp32 on the card: max |port - reference| {(got - want).abs().max().item():.3e}")
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_rwkv6_published_bf16_served_tokens_gap(device):
    """The bf16 program's greedy tokens (``Engine.generate``: K4 in bf16, the
    eager decode) judged as the benchmark judges them: the reference's best
    logit less its logit of each served token, on the bf16 weights."""
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, params, toks = _rwkv_case("bfloat16", 12)
    eng = Engine(cfg, params, EngineConfig(max_len=RWKV_PROMPT + RWKV_STEPS), device=device)
    served = torch.as_tensor(eng.generate(toks[:, :RWKV_PROMPT].numpy(), RWKV_STEPS),
                             dtype=torch.long)
    seq = torch.cat([toks[:, :RWKV_PROMPT], served[:, :-1]], 1)
    logits = _rwkv_reference(cfg, params, seq)[:, RWKV_PROMPT - 1:]
    gap = logits.max(-1).values - logits.gather(-1, served.cuda()[..., None])[..., 0]
    print(f"rwkv6 bf16 on the card: served tokens' gap max {gap.max().item():.4f}, "
          f"mean {gap.mean().item():.4f}")
    assert gap.max().item() < RWKV_BF16_GAP


def test_rwkv6_profiled_batch_holds_the_rwkv_ranges_and_counts(device):
    """One batch of prefill and two decode steps under the profiler on the
    card: each of ``rwkv.time_mix``, ``rwkv.wkv`` and ``rwkv.channel_mix``
    once a layer and call, K4 once a layer, ``wkv_tokens`` from the shapes
    and 3 host syncs."""
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, params, toks = _rwkv_case("bfloat16", 13)
    eng = Engine(cfg, params, EngineConfig(max_len=RWKV_PROMPT + RWKV_STEPS), device=device)
    eng.generate(toks[:, :RWKV_PROMPT].numpy(), 2)         # loads the kernels
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = wkv_k.launches
    with torch.profiler.profile(activities=acts) as prof:
        eng.generate(toks[:, :RWKV_PROMPT].numpy(), 2)
    counts = {e.key: e.count for e in prof.key_averages()}
    for name in ("rwkv.time_mix", "rwkv.wkv", "rwkv.channel_mix"):
        assert counts.get(name) == 3 * cfg.num_layers, (name, counts.get(name))
    assert wkv_k.launches == before + cfg.num_layers
    b, layers = toks.shape[0], cfg.num_layers
    assert eng.last_stats["wkv_tokens"] == {"kernel": b * RWKV_PROMPT * layers,
                                            "step": b * 2 * layers}
    assert sum(eng.last_stats["syncs"].values()) == 3
    assert eng.last_stats["graph_steps"] == 0
