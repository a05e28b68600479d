"""The plain references against the program's CPU path (the kernels' plain
versions over the same layouts) at a tiny size: a sound run reads correct,
with every number far under its limit; and the reference's own building
blocks against direct formulas."""

import math

import numpy as np
import pytest
import torch

from benchmark import plain, run
from benchmark.tests.conftest import tiny_cell

CELLS = ("pretrain.full.arxiv", "finetune.node.arxiv")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run.run_cell(tiny_cell(name), 2 ** 31 + 11, 0.3, False,
                       device="cpu")
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    for check in res["checks"].values():
        assert check["value"] <= check["limit"], res["checks"]
    assert list(res)[-1] == "checks"


def test_pair_keep_matches_the_program():
    from stemgnn_tpu_torch.ops.pairhash import pair_hash_keep
    g = torch.Generator().manual_seed(3)
    a = torch.randint(0, 1 << 20, (5000,), generator=g)
    b = torch.randint(0, 1 << 20, (5000,), generator=g)
    for seed in (0, 7, 2 ** 31 - 2):
        s = torch.tensor(seed)
        assert torch.equal(plain.pair_keep(s, a, b, 0.2),
                           pair_hash_keep(s, a, b, 0.2))
        assert torch.equal(plain.pair_keep(s, a, b, 0.2),
                           plain.pair_keep(s, b, a, 0.2))


def test_sage_mean_forward_and_backward():
    g = torch.Generator().manual_seed(0)
    n, d = 7, 5
    s = torch.tensor([0, 1, 2, 3, 3, 6, 5])
    r = torch.tensor([1, 1, 4, 4, 4, 0, 0])
    valid = torch.tensor([1, 1, 1, 1, 0, 1, 1], dtype=torch.bool)
    x = torch.randn(n, d, generator=g, requires_grad=True)
    t0 = torch.randn(1, d, generator=g)
    inv = plain.inv_in_degree(r, valid, n)
    out = plain.SageMean.apply(x, s, r, valid, t0, inv)
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    want = torch.zeros(n, d)
    deg = torch.zeros(n)
    for e in range(len(s)):
        if valid[e]:
            want[r[e]] += bf(torch.relu(bf(x[s[e]]) + bf(t0[0])))
            deg[r[e]] += 1
    want = want / deg.clamp(min=1)[:, None]
    assert torch.allclose(out, want, atol=1e-6)
    up = torch.randn(n, d, generator=g)
    out.backward(up)
    gp = bf(up * inv)
    dx = torch.zeros(n, d)
    for e in range(len(s)):
        if valid[e]:
            dx[s[e]] += gp[r[e]]
    dx = torch.where(bf(x) + bf(t0) > 0, dx, torch.zeros(()))
    assert torch.allclose(x.grad, dx, atol=1e-6)


def test_adamw_and_clip_match_torch():
    g = torch.Generator().manual_seed(1)
    p = {"a": torch.randn(4, 3, generator=g), "b": torch.randn(3, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) * 5 for k, v in p.items()}
             for _ in range(3)]
    ref = plain.AdamW(p, 1e-2, 0.1)
    tp = [torch.nn.Parameter(v.clone()) for v in p.values()]
    opt = torch.optim.AdamW(tp, lr=1e-2, weight_decay=0.1, eps=1e-8)
    cur = dict(p)
    for gr in grads:
        clipped = plain.clip_global(gr, 1.0)
        norm = math.sqrt(sum(float((v ** 2).sum()) for v in gr.values()))
        assert abs(math.sqrt(sum(float((v ** 2).sum())
                                 for v in clipped.values())) - 1.0) < 1e-5
        assert norm > 1.0
        cur = ref.step(cur, clipped)
        for t, v in zip(tp, clipped.values()):
            t.grad = v.clone()
        opt.step()
    for t, v in zip(tp, cur.values()):
        assert torch.allclose(t.detach(), v, atol=1e-6)


def test_cosine_factor():
    assert plain.cosine_factor(0, 50) == 1.0
    assert abs(plain.cosine_factor(25, 50) - 0.5) < 1e-12
    assert plain.cosine_factor(80, 50) == 0.0


def test_flip_takes_the_second_code():
    p = {"vq.project_in.w": torch.eye(4), "vq.project_in.b": torch.zeros(4),
         "vq.embed": torch.tensor([[[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]]])}
    z = torch.tensor([[1.0, 0.1, 1.0, 0.0], [1.0, 0.9, 1.0, 0.0]])
    p["vq.embed"] = p["vq.embed"].repeat(2, 1, 1)
    _, q0, scores = plain.quantize(p, z, heads=2, code_dim=2)
    _, q1, _ = plain.quantize(p, z, heads=2, code_dim=2, flip=1)
    changed = (q0 != q1).any(-1)
    # row 1's head 0 (0.74 vs 0.67) is nearest to a tie
    assert changed.sum() == 1 and bool(changed[0, 1])
    margin = plain.code_margin(scores)
    assert np.isclose(float(margin[1]), float(scores[0, 1].topk(2).values
                                              .diff().abs()))
