"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels build
with ``nvcc`` on first use); elsewhere they skip. The file imports no JAX,
so it also runs on a host that has only the port's dependencies::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

Tolerances: f32 within 1e-4 (the kernel sums in another order than the
plain version); bf16 within 2e-2 (p is rounded to bf16 before the P·V
product, and the output to bf16). The flash backward is held relative to
each gradient's max-abs: within 2e-2 in bf16 and 1e-3 in f32, since K2
sums dq with atomics in an order that changes from run to run and the
bf16 roundings of p and ds fall on values computed in another order. The
two-sweep backward (K3a, K3b) is held to the same tolerances; its dq has
no atomics and is bitwise equal from run to run, as is K1's output, and so
are K2's and K3b's dk and dv, which are summed inside one block.
"""

import pytest
import torch

from pddl_tpu_torch.ops import _kernels
from pddl_tpu_torch.ops import attention as tatt

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}

# (b, h, hkv, d, bs, t, depths): Llama-1B's decode shape at mixed depths
# (0, mid-block, T*bs-1), an odd group (rep 3, D 128), the CPU tests' tiny
# shape; then the edges of the kernel's split of the table (on an H100's
# 132 SMs the Llama shape takes 8 splits of 8 entries, 128 tokens each):
# depths at a split boundary and one past it (the 128 window crosses it),
# a table far wider than its rows, MHA, rep 8, D 256 with bs 64, and one
# row at Llama_1B's max_len (32 splits).
SHAPES = {
    "llama1b": (8, 32, 8, 64, 16, 64, [0, 7, 16, 100, 391, 512, 777, 1023]),
    "rep3_d128": (4, 12, 4, 128, 16, 8, [0, 5, 70, 127]),
    "tiny": (3, 4, 2, 8, 4, 6, [23, 0, 9]),
    "split_edges": (8, 32, 8, 64, 16, 64, [127, 128, 129, 255, 256, 0, 390,
                                           1023]),
    "wide_table": (4, 32, 8, 64, 16, 256, [0, 15, 16, 40]),
    "mha": (4, 32, 32, 64, 16, 64, [0, 127, 128, 1000]),
    "rep8": (4, 32, 4, 64, 16, 64, [1, 127, 128, 1023]),
    "d256_bs64": (2, 8, 2, 256, 64, 16, [63, 1023]),
    "long_row": (1, 32, 8, 64, 16, 256, [4095]),
    # GPT-2-small's paged tick: MHA (rep 1), 12 heads.
    "gpt_tick": (8, 12, 12, 64, 16, 64, [0, 7, 16, 100, 391, 512, 777,
                                         1023]),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _case(dev, dtype, b, h, hkv, d, bs, t, depths, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 1 + b * t
    kp = torch.randn(n, hkv, bs, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(n, hkv, bs, d, generator=gen, device=dev).to(dtype)
    table = torch.randperm(n - 1, generator=gen, device=dev)[:b * t] + 1
    q = torch.randn(b, h, 1, d, generator=gen, device=dev).to(dtype)
    index = torch.tensor(depths, dtype=torch.int32, device=dev)
    return q, kp, vp, table.view(b, t).to(torch.int32), index


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 6, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_paged_decode_kernel_matches_plain(shape, dtype, window):
    dev = _card()
    case = _case(dev, dtype, *SHAPES[shape])
    before = _kernels.launch_counts["paged_decode"]
    got = tatt.paged_decode_attention(*case, window=window)
    assert _kernels.launch_counts["paged_decode"] == before + 1
    ref = tatt.paged_decode_attention(*case, window=window, kernel=False)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - ref.float()).abs().max())
    assert err <= TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_reads_block_0_for_entries_out_of_range(dtype):
    dev = _card()
    q, kp, vp, table, index = _case(dev, dtype, *SHAPES["llama1b"])
    n = kp.shape[0]
    table[0, 0], table[3, 5], table[7, 60] = -7, n, n + 11
    got = tatt.paged_decode_attention_kernel(q, kp, vp, table, index)
    sink = torch.where((table >= 0) & (table < n), table, 0)
    ref = tatt.paged_decode_attention(q, kp, vp, sink, index, kernel=False)
    torch.cuda.synchronize()
    assert float((got.float() - ref.float()).abs().max()) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["llama1b", "long_row"])
def test_paged_decode_kernel_is_bitwise_reproducible(shape):
    """The splits merge in a fixed order: two runs are bitwise equal."""
    dev = _card()
    case = _case(dev, torch.bfloat16, *SHAPES[shape])
    first = tatt.paged_decode_attention_kernel(*case)
    assert torch.equal(first, tatt.paged_decode_attention_kernel(*case))


@pytest.mark.cuda
def test_paged_decode_kernel_raises_on_what_it_does_not_take():
    """A CUDA tensor launches the kernel or raises: no quiet fallback."""
    dev = _card()
    q, kp, vp, table, index = _case(dev, torch.float32, *SHAPES["tiny"])
    before = _kernels.launch_counts["paged_decode"]
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tatt.paged_decode_attention_kernel(q.half(), kp.half(), vp.half(),
                                           table, index)
    with pytest.raises(ValueError, match="int32"):
        tatt.paged_decode_attention_kernel(q, kp, vp, table.long(), index)
    with pytest.raises(ValueError, match="contiguous"):
        tatt.paged_decode_attention_kernel(
            q, kp.transpose(2, 3).contiguous().transpose(2, 3), vp, table,
            index)
    assert _kernels.launch_counts["paged_decode"] == before


# (b, h, hkv, sq, sk, d, dtype, causal, window, k_offset): Llama-1B's
# training shape, with a window, MHA, rep 3 at D 128, a ragged length that
# does not tile by 64, keys offset as in ring attention, f32, no mask, and a
# bf16 head width that is not a multiple of 16 (zero-padded in the kernel);
# then the edges of the bf16 kernels' 128-row q tiles and 64-key tiles: one
# row past a q tile, no mask with Sq != Sk (ragged in both), and a window
# narrower than a key tile; and the edges of the kv sweep's (K2, K3b)
# 128-key blocks: keys one past two blocks, and with a window narrower than
# a warp's 16 keys.
FLASH = {
    "llama1b": (4, 32, 8, 2048, 2048, 64, torch.bfloat16, True, None, 0),
    "llama1b_w512": (4, 32, 8, 2048, 2048, 64, torch.bfloat16, True, 512, 0),
    "mha": (2, 8, 8, 1024, 1024, 64, torch.bfloat16, True, None, 0),
    "rep3_d128": (2, 12, 4, 1024, 1024, 128, torch.bfloat16, True, None, 0),
    "ragged1000": (2, 8, 2, 1000, 1000, 64, torch.bfloat16, True, None, 0),
    "k_offset": (2, 8, 2, 512, 512, 64, torch.bfloat16, True, 384, -256),
    "f32": (2, 8, 2, 512, 512, 64, torch.float32, True, None, 0),
    "full_d16": (2, 4, 2, 200, 136, 16, torch.float32, False, None, 0),
    "d40": (2, 4, 2, 300, 300, 40, torch.bfloat16, True, None, 0),
    "s129": (2, 8, 2, 129, 129, 64, torch.bfloat16, True, None, 0),
    "full_bf16": (2, 4, 2, 200, 136, 64, torch.bfloat16, False, None, 0),
    "window6": (2, 8, 2, 300, 300, 64, torch.bfloat16, True, 6, 0),
    "sk257": (2, 8, 2, 257, 257, 64, torch.bfloat16, True, None, 0),
    "sk257_window12": (2, 8, 2, 257, 257, 64, torch.bfloat16, True, 12, 0),
    # The GPT-2-small train step (MHA, causal) and ViT-S/16's (non-causal,
    # 196 patches).
    "gpt_train": (8, 12, 12, 1024, 1024, 64, torch.bfloat16, True, None, 0),
    "vit_s16": (256, 6, 6, 196, 196, 64, torch.bfloat16, False, None, 0),
}


def _flash_case(dev, b, h, hkv, sq, sk, d, dtype, causal, window, k_offset,
                seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(b, h, sq, d, generator=gen, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, hkv, sk, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    dlse = torch.randn(b, h, sq, generator=gen, device=dev)
    kw = dict(causal=causal, scale=d ** -0.5, window=window,
              k_offset=k_offset)
    return q, k, v, do, dlse, kw


@pytest.mark.cuda
@pytest.mark.parametrize("want_lse", [True, False])
@pytest.mark.parametrize("shape", sorted(FLASH))
def test_flash_forward_kernel_matches_plain(shape, want_lse):
    dev = _card()
    q, k, v, _, _, kw = _flash_case(dev, *FLASH[shape])
    name = "flash_fwd" if want_lse else "flash_fwd_nolse"
    before = _kernels.launch_counts[name]
    o, lse = tatt.flash_forward(q, k, v, want_lse=want_lse, **kw)
    assert _kernels.launch_counts[name] == before + 1
    ref_o, ref_lse = tatt.flash_forward_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == q.dtype and torch.isfinite(o.float()).all()
    assert float((o.float() - ref_o.float()).abs().max()) <= TOL[q.dtype]
    if want_lse:
        assert lse.dtype == torch.float32 and lse.shape == ref_lse.shape
        assert float((lse - ref_lse).abs().max()) <= TOL[q.dtype]
    else:
        assert lse is None


@pytest.mark.cuda
@pytest.mark.parametrize("want_lse", [True, False])
@pytest.mark.parametrize("shape", ["llama1b", "s129"])
def test_flash_forward_is_bitwise_reproducible(shape, want_lse):
    """K1 has no atomics: two runs on the same inputs agree bit for bit,
    which the remat recompute relies on."""
    dev = _card()
    q, k, v, _, _, kw = _flash_case(dev, *FLASH[shape])
    first = tatt.flash_forward(q, k, v, want_lse=want_lse, **kw)
    second = tatt.flash_forward(q, k, v, want_lse=want_lse, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    if want_lse:
        assert torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("shape", sorted(FLASH))
def test_flash_backward_kernel_matches_plain(shape, with_dlse):
    dev = _card()
    q, k, v, do, dlse, kw = _flash_case(dev, *FLASH[shape])
    o, lse = tatt.flash_forward_plain(q, k, v, **kw)
    dlse = dlse if with_dlse else None
    before = _kernels.launch_counts["flash_bwd_fused"]
    got = tatt.flash_backward(q, k, v, o, lse, do, dlse, **kw)
    assert _kernels.launch_counts["flash_bwd_fused"] == before + 1
    want = tatt.flash_backward_plain(q, k, v, o, lse, do, dlse, **kw)
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert torch.isfinite(g.float()).all()
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= GRAD_TOL[q.dtype] * scale, (err, scale)


@pytest.mark.cuda
def test_flash_autograd_launches_both_kernels():
    """``flash_attention`` under a gradient runs K1 with the LSE and K2;
    without one, K1 with no LSE write."""
    dev = _card()
    q, k, v, do, _, _ = _flash_case(dev, *FLASH["f32"])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    _kernels.reset_launch_counts()
    o = tatt.flash_attention(*leaves, causal=True)
    o.backward(do)
    with torch.no_grad():
        tatt.flash_attention(q, k, v, causal=True)
    assert _kernels.launch_counts["flash_fwd"] == 1
    assert _kernels.launch_counts["flash_bwd_fused"] == 1
    assert _kernels.launch_counts["flash_fwd_nolse"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("s", [13, 1009])
def test_flash_prime_lengths_launch_the_kernels(s, with_lse):
    """A prime length tiles by no block of 8 or more; the kernels mask the
    ragged edge themselves, so both entry points still launch K1 and K2
    on CUDA tensors, whatever ``block_q``/``block_k`` say, and agree with
    autograd through the plain forward."""
    dev = _card()
    q, k, v, do, dlse, kw = _flash_case(dev, 2, 8, 2, s, s, 64,
                                        torch.float32, True, None, 0)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    entry = tatt.flash_attention_lse if with_lse else tatt.flash_attention
    _kernels.reset_launch_counts()
    out = entry(*leaves, causal=True, block_q=8, block_k=8)
    with torch.no_grad():
        entry(q, k, v, causal=True)
    o, lse = out if with_lse else (out, None)
    loss = (o * do).sum() + ((lse * dlse).sum() if with_lse else 0)
    loss.backward()
    counts = {name: _kernels.launch_counts[name]
              for name in ("flash_fwd", "flash_fwd_nolse", "flash_bwd_fused")}
    assert counts == {"flash_fwd": 2 if with_lse else 1,
                      "flash_fwd_nolse": 0 if with_lse else 1,
                      "flash_bwd_fused": 1}
    ref_o, ref_lse = tatt.flash_forward_plain(*plain, **kw)
    ref = (ref_o * do).sum() + ((ref_lse * dlse).sum() if with_lse else 0)
    ref.backward()
    assert float((o - ref_o).abs().max()) <= TOL[torch.float32]
    for g, w in zip(leaves, plain):
        scale = float(w.grad.abs().max())
        err = float((g.grad - w.grad).abs().max())
        assert err <= GRAD_TOL[torch.float32] * scale, (err, scale)


# The two-sweep backward's shapes: Llama-1B at S 8192, which takes the
# branch by the JAX package's test (rep 4 · S · D · 4 bytes = 8 MiB), then
# K2's odd shapes and prime lengths with the test's threshold at 0.
TWO_SWEEP = {
    "llama1b_s8192": (1, 32, 8, 8192, 8192, 64, torch.bfloat16, True, None,
                      0),
    **{name: FLASH[name] for name in ("llama1b_w512", "mha", "rep3_d128",
                                      "ragged1000", "k_offset", "f32",
                                      "d40", "s129", "full_bf16",
                                      "window6", "sk257",
                                      "sk257_window12")},
    "prime13": (2, 8, 2, 13, 13, 64, torch.float32, True, None, 0),
    "prime1009": (2, 8, 2, 1009, 1009, 64, torch.float32, True, None, 0),
}
BWD_COUNTERS = ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")


@pytest.mark.cuda
@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("shape", sorted(TWO_SWEEP))
def test_two_sweep_backward_kernels_match_plain(shape, with_dlse,
                                                monkeypatch):
    """K3a's dq and K3b's dk/dv against the plain version; one launch of
    each and none of K2."""
    dev = _card()
    q, k, v, do, dlse, kw = _flash_case(dev, *TWO_SWEEP[shape])
    if shape == "llama1b_s8192":
        assert tatt.takes_two_sweeps(q, k)
    else:
        monkeypatch.setattr(tatt, "_FUSED_BWD_DQ_BYTES", 0)
    o, lse = tatt.flash_forward_plain(q, k, v, **kw)
    dlse = dlse if with_dlse else None
    before = {name: _kernels.launch_counts[name] for name in BWD_COUNTERS}
    got = tatt.flash_backward(q, k, v, o, lse, do, dlse, **kw)
    after = {name: _kernels.launch_counts[name] for name in BWD_COUNTERS}
    assert after == {"flash_bwd_fused": before["flash_bwd_fused"],
                     "flash_bwd_dq": before["flash_bwd_dq"] + 1,
                     "flash_bwd_dkv": before["flash_bwd_dkv"] + 1}
    want = tatt.flash_backward_plain(q, k, v, o, lse, do, dlse, **kw)
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert torch.isfinite(g.float()).all()
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= GRAD_TOL[q.dtype] * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["llama1b", "f32", "s129"])
def test_two_sweep_dq_is_bitwise_reproducible(shape, monkeypatch):
    """K3a writes each dq element once, with no atomics: two runs agree
    bit for bit."""
    dev = _card()
    q, k, v, do, dlse, kw = _flash_case(dev, *FLASH[shape])
    monkeypatch.setattr(tatt, "_FUSED_BWD_DQ_BYTES", 0)
    o, lse = tatt.flash_forward(q, k, v, **kw)
    first = tatt.flash_backward(q, k, v, o, lse, do, dlse, **kw)
    second = tatt.flash_backward(q, k, v, o, lse, do, dlse, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", ["k2", "k3b"])
@pytest.mark.parametrize("shape", ["llama1b", "s129", "sk257"])
def test_kv_sweep_dk_dv_are_bitwise_reproducible(shape, sweep, monkeypatch):
    """K2 and K3b sum dk and dv over the query group inside one block and
    write each element once, with no atomics: two runs agree bit for bit."""
    dev = _card()
    q, k, v, do, dlse, kw = _flash_case(dev, *FLASH[shape])
    if sweep == "k3b":
        monkeypatch.setattr(tatt, "_FUSED_BWD_DQ_BYTES", 0)
    name = {"k2": "flash_bwd_fused", "k3b": "flash_bwd_dkv"}[sweep]
    o, lse = tatt.flash_forward(q, k, v, **kw)
    before = _kernels.launch_counts[name]
    first = tatt.flash_backward(q, k, v, o, lse, do, dlse, **kw)
    second = tatt.flash_backward(q, k, v, o, lse, do, dlse, **kw)
    torch.cuda.synchronize()
    assert _kernels.launch_counts[name] == before + 2
    for a, b in zip(first[1:], second[1:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_kernels_raise_on_what_they_do_not_take(monkeypatch):
    """A CUDA tensor launches the kernel or raises: wrong dtype, device or
    layout raise; the two-sweep branch launches K3a and K3b."""
    dev = _card()
    q, k, v, do, _, kw = _flash_case(dev, *FLASH["f32"])
    before = dict(_kernels.launch_counts)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tatt.flash_forward(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(ValueError, match="must be"):
        tatt.flash_forward(q, k.bfloat16(), v, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tatt.flash_forward(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                           v, **kw)
    with pytest.raises(ValueError, match="is on cpu"):
        tatt.flash_forward(q, k.cpu(), v, **kw)
    assert _kernels.launch_counts == before
    o, lse = tatt.flash_forward_plain(q, k, v, **kw)
    monkeypatch.setattr(tatt, "_FUSED_BWD_DQ_BYTES", 0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tatt.flash_backward(q.half(), k.half(), v.half(), o.half(), lse,
                            do.half(), **kw)
    assert _kernels.launch_counts == before
    tatt.flash_backward(q, k, v, o, lse, do, **kw)
    assert _kernels.launch_counts == {**before, "flash_bwd_dq":
                                      before["flash_bwd_dq"] + 1,
                                      "flash_bwd_dkv":
                                      before["flash_bwd_dkv"] + 1}


# The ring prefill of a sliding-window Llama-1B (``generate`` on a
# rolling cache): B 1, H 32/8, a ragged and a round S, window 1024.
RING_PREFILL = {
    "s1536": (1, 32, 8, 1536, 1536, 64, torch.bfloat16, True, 1024, 0),
    "s2048": (1, 32, 8, 2048, 2048, 64, torch.bfloat16, True, 1024, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(RING_PREFILL))
def test_ring_prefill_shapes_launch_k1_with_its_lse(shape):
    """``flash_attention_lse`` at the ring prefill's shapes launches K1
    with its LSE once, within bf16's tolerance of the plain version."""
    dev = _card()
    q, k, v, _, _, kw = _flash_case(dev, *RING_PREFILL[shape])
    _kernels.reset_launch_counts()
    with torch.no_grad():
        o, lse = tatt.flash_attention_lse(q, k, v, causal=True,
                                          window=kw["window"])
    assert _kernels.launch_counts["flash_fwd"] == 1
    assert sum(_kernels.launch_counts.values()) == 1
    ref_o, ref_lse = tatt.flash_forward_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert float((o.float() - ref_o.float()).abs().max()) <= TOL[q.dtype]
    assert float((lse - ref_lse).abs().max()) <= TOL[q.dtype]


@pytest.mark.cuda
def test_ring_chunked_prefill_on_the_card_matches_the_cpu():
    """A sliding-window tiny Llama (f32, window 100 under max_len 256: a
    ring of 128) takes three prefill chunks at nonzero indices, the
    second and third over a wrapped ring: each layer launches K1 with its
    LSE once a chunk, and the logits match the CPU twin's within 1e-4."""
    from pddl_tpu_torch.models.gpt import decode_cache
    from pddl_tpu_torch.models.llama import tiny_llama

    dev = _card()
    kw = dict(vocab_size=64, max_len=256, sliding_window=100, embed_dim=64,
              attention="flash")
    cpu = tiny_llama(device="cpu", **kw)
    card = tiny_llama(device=dev, **kw)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, 64, (1, 200),
                           generator=torch.Generator().manual_seed(3))
    caches = decode_cache(cpu, 1), decode_cache(card, 1)
    with torch.no_grad():
        for lo, hi in ((0, 80), (80, 150), (150, 200)):
            want = cpu(tokens[:, lo:hi], cache=caches[0], cache_index=lo)
            _kernels.reset_launch_counts()
            got = card(tokens[:, lo:hi].to(dev), cache=caches[1],
                       cache_index=lo)
            torch.cuda.synchronize()
            assert _kernels.launch_counts["flash_fwd"] == card.depth
            err = float((got.cpu() - want).abs().max())
            assert err <= 1e-4, (lo, hi, err)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["row", "paged", "draft"])
def test_spec_engine_on_the_card_matches_the_cpu(mode):
    """``ServeEngine(spec_k=3)`` on a tiny f32 Llama (width 64, depth 2,
    ``max_len`` 64) with repetitive prompts, one ending at ``max_len``:
    the card's streams and acceptance counters equal the CPU twin's. With
    a draft model (the target's first block as a depth-1 Llama) K4 runs
    the draft's single-token steps, ``depth x (spec_k + 1)`` launches a
    window; the n-gram engines launch none (the verify is multi-token)."""
    from pddl_tpu_torch.models.llama import tiny_llama
    from pddl_tpu_torch.serve.engine import ServeEngine

    dev = _card()
    kw = dict(vocab_size=64, max_len=64, embed_dim=64)
    cpu = tiny_llama(device="cpu", **kw)
    card = tiny_llama(device=dev, **kw)
    card.load_state_dict(cpu.state_dict())
    drafts = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        drafts[name] = tiny_llama(device=model.device, depth=1, **kw)
        drafts[name].load_state_dict({
            k: v for k, v in model.state_dict().items()
            if not k.startswith("blocks.1.")})
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(0, 64, (n,), generator=gen).tolist()
               for n in (4, 3, 5)]
    prompts = [(p * 8)[:n] for p, n in zip(prompts, (20, 12, 24))]
    news = (20, 30, 40)  # the last ends at max_len
    out = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        ekw = dict(max_slots=3, prefill_len=24, prefix_block_size=4,
                   spec_k=3, paged=mode != "row")
        if mode == "draft":
            ekw["spec_draft_model"] = drafts[name]
        eng = ServeEngine(model, device=model.device, **ekw)
        handles = [eng.submit(p, n) for p, n in zip(prompts, news)]
        _kernels.reset_launch_counts()
        eng.run()
        if name == "cuda":
            torch.cuda.synchronize()
        snap = eng.metrics.snapshot()
        out[name] = ([h.tokens for h in handles], snap["spec_ticks"],
                     snap["spec_accepted_tokens"],
                     dict(_kernels.launch_counts))
    assert out["cuda"][:3] == out["cpu"][:3]
    launches = out["cuda"][3]
    want = 1 * 4 * out["cuda"][1] if mode == "draft" else 0
    assert launches["paged_decode"] == want
    assert sum(launches.values()) == want


@pytest.mark.cuda
@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("mode", ["row", "paged"])
def test_tenant_engine_on_the_card_matches_the_cpu(mode, spec_k):
    """``ServeEngine(tenant=TenantConfig(...))`` on a tiny f32 Llama
    (width 64, depth 2, vocabulary 64): a base request, two LoRA
    adapters, a regex constraint and an adapter under a constraint. The
    card's streams, finish reasons and adapter counters equal the CPU
    twin's; on the paged one-token engine K4 runs every tenant tick, once
    a layer (``depth x ticks`` launches); the speculative verify is
    multi-token and launches none."""
    from pddl_tpu_torch.models.llama import tiny_llama
    from pddl_tpu_torch.serve.engine import ServeEngine
    from pddl_tpu_torch.serve.tenant import AdapterRegistry, TenantConfig

    dev = _card()
    kw = dict(vocab_size=64, max_len=64, embed_dim=64)
    cpu = tiny_llama(device="cpu", **kw)
    card = tiny_llama(device=dev, **kw)
    card.load_state_dict(cpu.state_dict())
    strings = (list("0123456789") + list('{}[]":,.-') + ["true", "false"]
               + list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ")
               )[:64]
    gen = torch.Generator().manual_seed(9)
    prompts = [torch.randint(0, 64, (n,), generator=gen).tolist()
               for n in (12, 9, 14, 11, 10)]
    digits = {"kind": "regex", "pattern": "[0-9]+"}
    subs = [{}, {"adapter": "a0"}, {"adapter": "a1"},
            {"constraint": {"kind": "regex", "pattern": "[0-9][0-9][0-9]"}},
            {"adapter": "a0", "constraint": digits}]
    out = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        reg = AdapterRegistry(64, 64, rank=4)
        for i in range(2):
            reg.register_random(f"a{i}", seed=100 + i, scale=0.1)
        eng = ServeEngine(model, device=model.device, max_slots=4,
                          prefill_len=16, prefix_block_size=4,
                          paged=mode == "paged", spec_k=spec_k,
                          tenant=TenantConfig(registry=reg,
                                              token_strings=strings))
        handles = [eng.submit(p, 12, **s) for p, s in zip(prompts, subs)]
        _kernels.reset_launch_counts()
        eng.run()
        if name == "cuda":
            torch.cuda.synchronize()
        ticks = sum(1 for r in eng.telemetry.snapshot()
                    if r["live_slots"] > 0)
        snap = eng.metrics.snapshot()
        out[name] = ([h.tokens for h in handles],
                     [h.finish_reason for h in handles],
                     (snap["adapter_loads"], snap["adapter_hits"],
                      snap["requests_grammar_complete"]),
                     dict(_kernels.launch_counts), ticks)
        assert eng._apool.pinned_rows() == []
    assert out["cuda"][:3] == out["cpu"][:3]
    assert out["cuda"][1][3].value == "grammar"
    launches, ticks = out["cuda"][3], out["cuda"][4]
    want = card.depth * ticks if mode == "paged" and not spec_k else 0
    assert launches["paged_decode"] == want
    assert sum(launches.values()) == want


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["row", "paged", "int8_paged"])
def test_gpt_engine_on_the_card_matches_the_cpu(mode):
    """``ServeEngine`` on a tiny f32 GPT (width 64, 4 heads, depth 2,
    ``max_len`` 64), both modes and int8 weights
    (``quantize_int8(min_elems=1024)``, ``param_transform=dequantize``):
    the card's streams equal the CPU twin's; the paged engine runs K4 once
    a layer a tick (``depth x ticks``), at rep 1; the row engine none."""
    from pddl_tpu_torch.models.gpt import tiny_gpt
    from pddl_tpu_torch.ops.quant import dequantize, quantize_int8
    from pddl_tpu_torch.serve.engine import ServeEngine

    dev = _card()
    kw = dict(vocab_size=64, max_len=64, embed_dim=64)
    cpu = tiny_gpt(device="cpu", **kw)
    card = tiny_gpt(device=dev, **kw)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 64, (n,), generator=gen).tolist()
               for n in (12, 9, 20)]
    out = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        ekw = dict(max_slots=3, prefill_len=24, prefix_block_size=4,
                   paged=mode != "row")
        if mode == "int8_paged":
            ekw.update(variables={"params": quantize_int8(
                model, min_elems=1024)}, param_transform=dequantize)
        eng = ServeEngine(model, device=model.device, **ekw)
        handles = [eng.submit(p, 16) for p in prompts]
        _kernels.reset_launch_counts()
        eng.run()
        if name == "cuda":
            torch.cuda.synchronize()
        ticks = sum(1 for r in eng.telemetry.snapshot()
                    if r["live_slots"] > 0)
        out[name] = ([h.tokens for h in handles],
                     dict(_kernels.launch_counts), ticks)
    assert out["cuda"][0] == out["cpu"][0]
    launches, ticks = out["cuda"][1], out["cuda"][2]
    want = card.depth * ticks if mode != "row" else 0
    assert launches["paged_decode"] == want
    assert sum(launches.values()) == want


@pytest.mark.cuda
def test_quantize_int8_on_the_card_equals_the_cpu():
    """``quantize_int8`` on the card gives the CPU's ``qvalue`` and scales
    bit for bit (IEEE division for the scale, as in the JAX package), and
    ``dequantize`` the CPU's dense weights."""
    from pddl_tpu_torch.models.gpt import tiny_gpt
    from pddl_tpu_torch.ops.quant import dequantize, quantize_int8

    dev = _card()
    cpu = tiny_gpt(vocab_size=512, max_len=64, embed_dim=128, device="cpu")
    card = tiny_gpt(vocab_size=512, max_len=64, embed_dim=128, device=dev)
    card.load_state_dict(cpu.state_dict())
    qc, qg = (quantize_int8(m, min_elems=64) for m in (cpu, card))
    leaves = [k for k, v in qc.items() if isinstance(v, dict)]
    assert len(leaves) > 13  # the [H, D] q/k/v biases too
    for k in leaves:
        for f in ("qvalue", "scale"):
            assert torch.equal(qg[k][f].cpu(), qc[k][f]), (k, f)
    dc, dg = dequantize(qc), dequantize(qg)
    for k in qc:
        assert torch.equal(dg[k].cpu(), dc[k]), k
