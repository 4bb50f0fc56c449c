"""The frozen work counts against hand counts at small shapes."""
import itertools

import torch

import benchutil  # noqa: F401  (puts the harness on the path)
from mrabench import work


def _hand_chunk(q_pos, counts, *, Hkv, G, D, b, m, elem):
    """Row by row: the keys a row must attend exactly (its own page up to
    it, then any m - 1 earlier full pages), the pages it scores, the
    pages some selection must read."""
    flops = rows = 0
    union = 0
    filled = sum(1 for c in counts.flatten().tolist() if c > 0)
    for s in range(q_pos.shape[0]):
        length = int(counts[s].sum())
        own_pages, need = set(), 0
        for p in q_pos[s].tolist():
            if not 0 <= p < length:
                continue
            rows += 1
            own = p // b
            past = list(range(own))
            chosen = past[:m - 1]
            keys = sum(b for _ in chosen) + (p - own * b + 1)
            bg = len(past) - len(chosen)
            flops += Hkv * G * (4 * D * keys + 2 * D * len(past) + 2 * D * bg)
            own_pages.add(own)
            need = max(need, len(chosen) + 1)
        union += max(len(own_pages), need)
    nbytes = (Hkv * union * 2 * b * D * elem + Hkv * filled * 2 * D * 4
              + filled * 8 + 2 * Hkv * G * rows * D * 4 + rows * 4)
    return flops, nbytes


def _case(lengths, starts, C, nb, b):
    q_pos = torch.stack([torch.arange(C) + s for s in starts])
    counts = torch.stack([torch.clamp(L - torch.arange(nb) * b, 0, b)
                          for L in lengths]).float()
    return q_pos, counts


def test_chunk_count_matches_a_hand_count():
    kw = dict(Hkv=2, G=3, D=16, b=4, m=3, elem=2)
    for lengths, starts, C in [((14, 5), (8, 4), 8), ((30, 1), (0, 0), 16),
                               ((3, 29), (2, 28), 1)]:
        q_pos, counts = _case(lengths, starts, C, 8, 4)
        f, n = work.chunk_call(q_pos, counts, **kw)
        hf, hn = _hand_chunk(q_pos, counts, **kw)
        assert float(f) == hf and float(n) == hn


def test_chunk_count_does_not_depend_on_tiling_or_padding():
    """The program's own budget count moves with the kernel's query tile;
    this count takes no tile, and padded rows or empty pages change
    nothing."""
    from repro_torch.kernels.cost import chunk_budget

    kw = dict(Hkv=2, G=2, D=16, b=4, m=3, elem=2)
    q_pos, counts = _case((14, 9), (6, 1), 8, 8, 4)
    base = [float(x) for x in work.chunk_call(q_pos, counts, **kw)]
    budgets = {c: chunk_budget(2, 2, 2, 8, 4, 8, 3, c) for c in (1, 2, 8)}
    assert len(set(budgets.values())) > 1
    padded_rows = torch.cat([q_pos, q_pos[:, -1:] + 1 + torch.arange(8)], 1)
    more_pages = torch.cat([counts, torch.zeros(2, 8)], 1)
    for qp, cn in [(padded_rows, counts), (q_pos, more_pages)]:
        assert [float(x) for x in work.chunk_call(qp, cn, **kw)] == base


def test_bsa_count_matches_a_hand_count():
    flags = torch.tensor([[1, 1, 3, 0], [1, 3, 0, 0]], dtype=torch.int32)
    b, d = 4, 8
    entries = 3 * b * b + 2 * b * (b + 1) // 2
    for kernel, products in work.PRODUCTS.items():
        f, _ = work.bsa_call(kernel, flags, BHG=2, BHKV=1, n=16, d=d, b=b,
                             elem=2)
        assert float(f) == 2 * products * entries * d
    _, fwd_bytes = work.bsa_call("bsa_fwd", flags, BHG=2, BHKV=1, n=16, d=d,
                                 b=b, elem=2)
    assert fwd_bytes == ((2 + 2) * 16 * d * 2 + 16 * 4 + 8 * 4
                         + 2 * 4 * 4 + 2 * 16 * (d + 2) * 4)


def test_model_flops_by_hand():
    model = {"num_layers": 2, "d_model": 8, "num_heads": 2, "kv_heads": 1,
             "head_dim": 4, "d_ff": 16, "vocab": 10,
             "attention": {"block_size": 4, "blocks_per_row": 2,
                           "decode_blocks": 2}}
    per_token = 2 * (8 * 2 * 4 * 2 + 8 * 1 * 4 * 2 + 3 * 8 * 16)  # 2 layers
    assert work.matmul_params_per_token(model) == per_token
    # a prompt of 6 and 2 new tokens: 7 positions fed, 2 heads
    att = 0
    for p in range(7):
        own, past = p // 4, p // 4
        keys = p + 1 if past + 1 <= 2 else 4 + p % 4 + 1
        att += 2 * 2 * (4 * 4 * keys + 2 * 4 * past + 2 * 4 * max(past - 1, 0))
    want = 2 * per_token * 7 + att + 2 * 8 * 10 * 2
    assert work.serve_request_flops(model, 6, 2) == want
    # training, n = 8: 2 blocks, 3 allowed pairs, budget min(4, 3) = 3
    entries = 2 * 4 * 5 / 2 + 1 * 16
    att = 2 * 2 * (4 * 4 * entries + 2 * 4 * 3 + 0)
    assert work.train_sequence_flops(model, 8) == (
        2 * per_token * 8 + att + 2 * 8 * 10 * 8)


def test_least_time_is_the_larger_bound():
    for f, n in itertools.product((0.0, 1e12), (0.0, 1e9)):
        assert work.least_s(f, n) == max(f / work.BF16_FLOP_PER_S,
                                         n / work.HBM_BYTES_PER_S)
