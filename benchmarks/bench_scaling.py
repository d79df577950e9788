#!/usr/bin/env python
"""Sharded-NTT scaling bench with per-phase breakdown (BASELINE config 5).

Measures deg-2^20 four-step NTT ring-mul throughput at 1 / 2 / 4 / 8
devices AND times each forward phase separately (column stage /
all_to_all exchange / row stage) so collective cost is attributable.
Prints one JSON line per device count, each naming the platform.

Runs on the devices JAX finds, in this one process, and skips device
counts it does not have.  On a CPU-only machine a virtual mesh is
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8``;
there all "devices" share the host's cores, so the efficiency column
measures host parallelism, not the sharding design.

Run:  python benchmarks/bench_scaling.py [--shardcompute]
"""

import json
import sys
import time

import numpy as np


def _timeit(fn, args, iters=5):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        best = dt if best is None else min(best, dt)
    return best


def main(N=1 << 20, counts=(1, 2, 4, 8), batch=2):
    import pathlib

    import jax

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from bench import device_info
    from stark_rings_tpu.fields import get_field
    from stark_rings_tpu.parallel import ShardedNTT, make_mesh
    from stark_rings_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    f = get_field("goldilocks")
    rng = np.random.default_rng(0)
    base = None
    records = []
    for Pn in counts:
        if len(jax.devices()) < Pn:
            continue
        sn = ShardedNTT("goldilocks", N, Pn)
        mesh = make_mesh(Pn)
        _, _, mul = sn.make_fns(mesh, batch_ndim=1)
        phases = sn.make_phase_fns(mesh, batch_ndim=1)
        a = sn.to_matrix(rng.integers(0, f.q, size=(batch, N),
                                      dtype=np.uint64))
        b = sn.to_matrix(rng.integers(0, f.q, size=(batch, N),
                                      dtype=np.uint64))

        # overlap variant (batch-pipelined forward, the make_fns default
        # for even batches): same math, exchange hidden behind chunk i+1's
        # column stage on a real interconnect
        fwd_ov, _, mul_ov = sn.make_fns(mesh, batch_ndim=1, overlap=True)

        t_mul = _timeit(mul, (a, b))
        t_fwd = _timeit(phases["forward"], (a,))
        t_fwd_ov = _timeit(fwd_ov, (a,))
        t_mul_ov = _timeit(mul_ov, (a, b))
        t_pre = _timeit(phases["pre"], (a,))
        pre_out = phases["pre"](a)
        t_exch = _timeit(phases["exchange"], (pre_out,))
        exch_out = phases["exchange"](pre_out)
        t_rows = _timeit(phases["rows"], (exch_out,))

        rate = batch / t_mul
        if base is None:
            base = rate
        eff = rate / (base * Pn / counts[0])
        rec = {
            "devices": Pn, "deg": N,
            "ring_mults_per_sec": round(rate, 3),
            "scaling_efficiency": round(eff, 4),
            "phase_ms": {
                "pre_col_stage": round(t_pre * 1e3, 2),
                "all_to_all": round(t_exch * 1e3, 2),
                "row_stage": round(t_rows * 1e3, 2),
                "forward_fused": round(t_fwd * 1e3, 2),
                "forward_overlap": round(t_fwd_ov * 1e3, 2),
                "full_mul": round(t_mul * 1e3, 2),
                "full_mul_overlap": round(t_mul_ov * 1e3, 2),
            },
            "exchange_frac_of_forward": round(t_exch / t_fwd, 4),
            **device_info(),
        }
        records.append(rec)
        print(json.dumps(rec))
        art = pathlib.Path(__file__).resolve().parent.parent \
            / "chiprun_out" / "SCALING.json"
        art.parent.mkdir(exist_ok=True)
        art.write_text("\n".join(json.dumps(r) for r in records) + "\n")


def shardcompute(N=1 << 20, counts=(1, 2, 4, 8), B=8):
    """The local COMPUTE of one shard of the sharded multiply, per P.

    Measures the P-shard local stage shapes — column twist+NTT+twiddle
    at [B, N1, N2/P] and row NTT at [B, N1/P, N2] — as in-module
    depth-differenced chains on one device, so shard-shape effects are
    in the number; ``compute_scaling`` is the ideal 1/P time over the
    measured local time (collectives excluded).

    Run:  python benchmarks/bench_scaling.py --shardcompute
    Artifact: chiprun_out/SHARDCOMPUTE.json
    """
    import pathlib

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from bench import chain_rate, device_info
    from stark_rings_tpu.fields import get_field
    from stark_rings_tpu.parallel import ShardedNTT
    from stark_rings_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    f = get_field("goldilocks")
    rng = np.random.default_rng(5)
    out = {"deg": N, "batch": B, "per_p": {}, **device_info()}
    art = pathlib.Path(__file__).resolve().parent.parent / "chiprun_out" \
        / "SHARDCOMPUTE.json"
    art.parent.mkdir(exist_ok=True)

    t_single = None
    for Pn in counts:
        sn = ShardedNTT("goldilocks", N, Pn)
        sn.consts()
        # shard-0 constants: the per-shard compute COST is identical on
        # every shard (same shapes, different constant values)
        sn._col_ofs = lambda: jnp.int64(0)
        N1, N2 = sn.N1, sn.N2
        C, R1 = N2 // Pn, N1 // Pn
        # scale the batch with P so the differenced signal stays tens of
        # ms as per-shard work shrinks
        Bp = min(B * Pn, 64)

        def build_pre(depth, sn=sn, N1=N1, C=C, Bp=Bp):
            x = jax.device_put(rng.integers(0, f.q, size=(Bp, N1, C),
                                            dtype=np.uint64))

            def fn(x):
                for _ in range(depth):
                    x = sn._pre_transpose(x)
                return x
            return jax.jit(fn), (x,)

        def build_rows(depth, sn=sn, R1=R1, N2=N2, Bp=Bp):
            y = jax.device_put(rng.integers(0, f.q, size=(Bp, R1, N2),
                                            dtype=np.uint64))

            def fn(y):
                for _ in range(depth):
                    y = sn._apply_on_axis(sn._local_fns()[2], y, 1)
                return y
            return jax.jit(fn), (y,)

        def build_pw(depth, R1=R1, N2=N2, Bp=Bp):
            ya = jax.device_put(rng.integers(0, f.q, size=(Bp, R1, N2),
                                            dtype=np.uint64))
            yb = jax.device_put(rng.integers(0, f.q, size=(Bp, R1, N2),
                                            dtype=np.uint64))

            def fn(ya, yb):
                for _ in range(depth):
                    ya = f.mul(ya, yb)
                return ya
            return jax.jit(fn), (ya, yb)

        rec = {"batch": Bp}
        for key, build, lo, hi in (
                ("pre_col_stage", build_pre, 1, 5),
                ("row_stage", build_rows, 1, 5),
                ("pointwise", build_pw, 2, 18)):
            rate, _ = chain_rate(build, Bp, lo=lo, hi=hi, reps=5)
            rec[key + "_us_per_elem"] = round(1e6 / rate, 2)
        # per-element local mul time at this shard shape: 3 transforms
        # (fwd a, fwd b, inverse — same stage structure) + pointwise
        t_local = 3 * (rec["pre_col_stage_us_per_elem"]
                       + rec["row_stage_us_per_elem"]) * 1e-6 \
            + rec["pointwise_us_per_elem"] * 1e-6
        rec["local_mul_us_per_elem"] = round(t_local * 1e6, 1)
        if Pn == counts[0]:
            t_single = t_local
        ideal = t_single / Pn
        rec["compute_scaling"] = round(ideal / t_local, 4)
        out["per_p"][str(Pn)] = rec
        print(json.dumps({"P": Pn, **rec}), flush=True)
        art.write_text(json.dumps(out) + "\n")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if "--shardcompute" in sys.argv:
        shardcompute()
    else:
        main()
