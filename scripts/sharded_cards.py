"""Sharded flat and IVF search over every visible card (the default
devices), against the unsharded index on cuda:0, at SIFT1M shape
(1M×128 from default_rng(42), nq=100, k=10).

    python scripts/sharded_cards.py        # e.g. on four cards

For f32, int8 and bf16: ShardedIndexFlat over all cards (P = cards) and
with num_replicas=2 (P = cards / 2; replica 1's shards are copies on the
other cards): ids equal to the unsharded index's; f32 also filtered and
range_search. IVF: a TorchIndexIVFFlat (1024 lists, f32) saved and loaded
with load_index(sharded=True), and a ShardedIndexIVFFlat (bf16) trained
and filled across the cards, ids equal to the single index's at nprobe 16
and 1024. Each search runs as one CUDA graph a card (the first card's
also merges): its replays must equal the eager search bit for bit
(``replays equal``). Prints the host ms a batch of each (20 searches after
one warm-up), the launch counts, and ALL OK, or exits 1 on a mismatch."""
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np  # noqa: E402
import torch  # noqa: E402
import faiss_tpu_torch as ft  # noqa: E402
from faiss_tpu_torch import programs  # noqa: E402
from faiss_tpu_torch.ops import kernels  # noqa: E402

n = torch.cuda.device_count()
print("devices", n, [torch.cuda.get_device_name(i) for i in range(n)], flush=True)
print(ft.gpu_name_and_power_limit(), flush=True)
rng = np.random.default_rng(42)
xb = rng.standard_normal((1_000_000, 128)).astype(np.float32)
xq = rng.standard_normal((100, 128)).astype(np.float32)

def replays_equal(cached, eager):
    """Two calls of the cached search (a build, then a replay) against the
    eager one, bit for bit."""
    ref = eager().contiguous().view(torch.int32)
    return all(torch.equal(cached().contiguous().view(torch.int32), ref)
               for _ in range(2))


def eagerly(fn):
    """``fn`` run under ``programs.eager()``: no program, no cache entry."""
    def run():
        with programs.eager():
            return fn()
    return run


def host_ms(fn, reps=20):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3

ok = True
for st in ("f32", "int8", "bf16"):
    single = ft.TorchIndexFlat(128, storage=st, device="cuda:0")
    single.add(xb)
    D1, I1 = single.search(xq, 10)
    for reps_ in (1, 2):
        sh = ft.ShardedIndexFlat(128, storage=st, num_replicas=reps_)
        sh.add(xb)
        kernels.reset_launches()
        Ds, Is = sh.search(xq, 10)
        launches = {k: v for k, v in kernels.launches.items() if v}
        q, _, nq_pad = sh._prep_queries(xq)
        rep = replays_equal(
            lambda: sh._run_search_fn(q, 10, nq_pad, force_plain=False)[0],
            eagerly(lambda: sh._run_search_fn(q, 10, nq_pad,
                                              force_plain=False)[0]))
        same = np.array_equal(Is, I1)
        ok &= same and rep
        print(f"{st} R={reps_} P={sh.num_shards} devices={[str(d) for d in sh.devices]}: ids equal {same}, "
              f"max|dD| {np.abs(Ds - D1).max():.3e}, fallbacks {sh.fused_fallbacks}/{single.fused_fallbacks}, "
              f"copies {len(sh._replicas)}, replays equal {rep}; host ms sharded {host_ms(lambda: sh.search(xq, 10)):.3f} "
              f"single {host_ms(lambda: single.search(xq, 10)):.3f}; launches {launches}", flush=True)
        if st == "f32" and reps_ == 1:
            sel = ft.SearchParams(sel=ft.IDSelectorRange(100_000, 700_000))
            same = np.array_equal(sh.search(xq, 10, params=sel)[1],
                                  single.search(xq, 10, params=sel)[1])
            lims_s, _, Ir_s = sh.range_search(xq[:8], 150.0)
            lims_1, _, Ir_1 = single.range_search(xq[:8], 150.0)
            rs = np.array_equal(lims_s, lims_1) and np.array_equal(Ir_s, Ir_1)
            ok &= same and rs
            print(f"f32 selector ids equal {same}; range_search equal {rs} ({lims_s[-1]} hits)", flush=True)
        del sh
    del single
    torch.cuda.empty_cache()

ivf = ft.TorchIndexIVFFlat(128, 1024, nprobe=16, device="cuda:0")
ivf.train(xb[:200_000])
ivf.add(xb)
D1, I1 = ivf.search(xq, 10)
with tempfile.TemporaryDirectory() as tmp:
    ft.save_index(ivf, f"{tmp}/ivf.npz")
    shi = ft.load_index(f"{tmp}/ivf.npz", sharded=True)
Ds, Is = shi.search(xq, 10)
same = np.array_equal(Is, I1)
rep = replays_equal(lambda: shi._search_packed(xq, 10)[0],
                    eagerly(lambda: shi._search_packed(xq, 10)[0]))
ok &= same and rep
print(f"ivf f32 nprobe 16 P={shi.num_shards}: ids equal {same}, replays equal {rep}; host ms sharded "
      f"{host_ms(lambda: shi.search(xq, 10)):.3f} single {host_ms(lambda: ivf.search(xq, 10)):.3f}", flush=True)
shi2 = ft.ShardedIndexIVFFlat(128, 1024, nprobe=16, storage="bf16")
shi2.train(xb[:200_000]); shi2.add(xb)
one = ft.TorchIndexIVFFlat(128, 1024, nprobe=16, storage="bf16", device="cuda:0")
one.train(xb[:200_000]); one.add(xb)
for npb in (16, 1024):
    shi2.nprobe = one.nprobe = npb
    same = np.array_equal(shi2.search(xq, 10)[1], one.search(xq, 10)[1])
    ok &= same
    print(f"ivf bf16 trained sharded over {shi2.num_shards} cards, nprobe {npb}: ids equal the single index's {same}", flush=True)
print("ALL OK" if ok else "MISMATCH", flush=True)
sys.exit(0 if ok else 1)
