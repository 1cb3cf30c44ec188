"""On the card (marked ``cuda``; each test skips without one): a tiny cell
through the harness on the device, its trace read, and the control with
the card's own TF32 products in place of the emulated ones.

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_cuda.py
"""

import numpy as np
import pytest
import torch

from benchmark import datagen, harness, reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_bench_traced_cell_on_the_card(card, tiny_spec):
    name = "deep1m-l2.batch"
    out = harness.run_cell(name, 2 ** 31 + 3, 2.0, True, device=card,
                           spec=tiny_spec(name, rows=200_000, queries=1000))
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["sweep_roofline.batch1m"]["value"] <= 105
    assert 0 <= out["metrics"]["idle_share.batch1m"]["value"] < 100


def test_bench_native_tf32_control_fails(card):
    spec = harness.cell_spec("deep1m-l2.single")
    data = dict(spec["config"]["data"], rows=100_000, queries=1000,
                chunk_rows=50_000)
    src = datagen.Source(data, 17, card)
    pool = src.queries()
    rows = torch.cat([r for _, r in src.chunks()])
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        dots = pool @ rows.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    cost = (pool * pool).sum(1)[:, None] + (rows * rows).sum(1)[None] \
        - 2 * dots
    d, i = torch.topk(cost, 10, dim=1, largest=False)
    n = len(pool)
    ans = reference.Answers.unique(np.arange(n), np.full(n, -1),
                                   d.cpu().numpy(), i.cpu().numpy())
    nums = reference.judge(ans, pool, src.chunks, 10, True, data["rows"], [])
    checks, correct = harness.verdict(nums, 0, spec["config"]["limits"])
    assert correct is False, checks
