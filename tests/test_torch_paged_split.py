"""The paged decode kernel's split of the table (`paged_split_plan` in
`pddl_tpu_torch/ops/attention.py`), on the CPU with no JAX.

- For a grid of (B, Hkv, T, bs, SM count) the plan is a function of those
  arguments alone; its ranges cover the table's entries `[0, T)` exactly
  once, none of them empty, each at most 8 entries and 128 tokens; it has
  one split where one block per (row, kv head) already fills the card.
- A plain twin of what `csrc/paged_decode.cu` computes — each split's
  partial (m, l, acc) over its range, then the merge
  `sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s, 1e-30)` — agrees with
  `_paged_attention_plain` within 1e-5 in f32 (the same sums in another
  order), including rows at depth 0, rows whose splits lie wholly past
  their depth or before their window, and windows that cross a split
  boundary. The twin is only a test's: the card runs the kernel.
"""

import itertools

import pytest
import torch

from pddl_tpu_torch.ops import attention as tatt

GRID = list(itertools.product((1, 2, 8, 64, 200), (1, 8), (1, 6, 64, 256),
                              (4, 16, 64), (8, 132)))


@pytest.mark.parametrize("b,hkv,t,bs,sms", GRID)
def test_split_plan_covers_the_table_once(b, hkv, t, bs, sms):
    n_split, per = tatt.paged_split_plan(b, hkv, t, bs, sms)
    assert (n_split, per) == tatt.paged_split_plan(b, hkv, t, bs, sms)
    ranges = [range(s * per, min(t, (s + 1) * per)) for s in range(n_split)]
    assert all(len(r) > 0 for r in ranges)
    assert [j for r in ranges for j in r] == list(range(t))
    if b * hkv >= sms:
        assert (n_split, per) == (1, t)
    else:
        assert per <= max(1, min(8, 128 // bs))


def test_split_plan_at_the_engine_and_long_row_shapes():
    """H100 (132 SMs): the serve tick (B 8, Hkv 8, T 64, bs 16) takes 8
    splits of 8 entries; one row at Llama-1B's max_len (T 256) takes 32;
    132 rows of 8 kv heads fill the card with one split each."""
    assert tatt.paged_split_plan(8, 8, 64, 16, 132) == (8, 8)
    assert tatt.paged_split_plan(1, 8, 256, 16, 132) == (32, 8)
    assert tatt.paged_split_plan(1, 8, 64, 16, 132) == (32, 2)
    assert tatt.paged_split_plan(17, 8, 64, 16, 132) == (1, 64)


def _split_then_merge(q, k_pool, v_pool, table, index, scale, window,
                      n_split, per):
    """The kernel's arithmetic in plain torch: per split, the softmax
    state over its live positions; then the ordered merge."""
    b, h, _, d = q.shape
    _, hkv, bs, _ = k_pool.shape
    t = table.shape[1]
    rep = h // hkv
    out = torch.empty(b, h, 1, d)
    for row in range(b):
        depth = int(index[row])
        for head in range(h):
            g = head // rep
            ms, ls, accs = [], [], []
            for s in range(n_split):
                lo = s * per * bs
                hi = min(min(t, (s + 1) * per) * bs, depth + 1)
                if window is not None:
                    lo = max(lo, depth - window + 1)
                if lo >= hi:
                    ms.append(torch.tensor(tatt.NEG_INF))
                    ls.append(torch.tensor(0.0))
                    accs.append(torch.zeros(d))
                    continue
                pos = torch.arange(lo, hi)
                blk = table[row, pos // bs].long()
                k = k_pool[blk, g, pos % bs].float()
                v = v_pool[blk, g, pos % bs].float()
                sc = (k @ q[row, head, 0].float()) * scale
                m = sc.max()
                p = torch.exp(sc - m)
                ms.append(m)
                ls.append(p.sum())
                accs.append(p.to(v_pool.dtype).float() @ v)
            mx = torch.stack(ms).max()
            w = torch.exp(torch.stack(ms) - mx)
            den = (w * torch.stack(ls)).sum()
            num = (w[:, None] * torch.stack(accs)).sum(0)
            out[row, head, 0] = num / den.clamp_min(1e-30)
    return out.to(q.dtype)


CASES = {
    # (b, h, hkv, d, bs, t, depths, window, sms)
    "split_edges": (4, 4, 2, 8, 4, 16, [0, 15, 16, 17], None, 16),
    "window_across_splits": (3, 4, 2, 8, 4, 16, [30, 50, 63], 10, 8),
    "wide_table": (2, 8, 8, 8, 4, 64, [0, 40], None, 32),
    "rep8_window_before_splits": (2, 16, 2, 8, 4, 32, [100, 127], 3, 8),
    "one_split": (2, 4, 2, 8, 4, 6, [23, 0], 6, 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_then_merge_matches_plain(name):
    b, h, hkv, d, bs, t, depths, window, sms = CASES[name]
    gen = torch.Generator().manual_seed(7)
    n = 1 + b * t
    k_pool = torch.randn(n, hkv, bs, d, generator=gen)
    v_pool = torch.randn(n, hkv, bs, d, generator=gen)
    table = (torch.randperm(n - 1, generator=gen)[:b * t] + 1).view(b, t)
    table = table.to(torch.int32)
    q = torch.randn(b, h, 1, d, generator=gen)
    index = torch.tensor(depths, dtype=torch.int32)
    n_split, per = tatt.paged_split_plan(b, hkv, t, bs, sms)
    assert (n_split == 1) == (name == "one_split")
    got = _split_then_merge(q, k_pool, v_pool, table, index, d ** -0.5,
                            window, n_split, per)
    want = tatt._paged_attention_plain(q, k_pool, v_pool, table, index,
                                       d ** -0.5, window)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
