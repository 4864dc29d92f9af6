"""NL forward throughput and its share of the card's peak against the model
width, on the GPU (the port's counterpart of ``scripts/bench_mxu_sweep.py``).

    python3 scripts/bench_mxu_sweep_torch.py [--widths 128,256,512,1024] [--dtypes float32,bfloat16]
        [--batch 8192] [--chain 50] [--reps 10] [--json out.json] [--device cuda]

The workload keeps the planner's structure: a chain of sequentially
dependent NL forwards, each query's state the previous output and its
action window rolled forward with an action derived from that state, so
nothing is loop-invariant. ``measure_one`` times ``--reps`` chains of
``--chain`` forwards at ``--batch`` rows on the plain PyTorch route (the
model's ``apply``; bfloat16 runs the GRU and trunk in bf16) and, at widths
the kernel takes (``nl_hidden_units`` <= 128, csrc/nl_kernels.cu), on the
kernel route (``make_fused_planner_apply``, float32 only). FLOPs per forward
come from the analytic count of ``bench.py`` (matrix products at 2 FLOPs a
multiply-add, the fourier combine at 10 FLOPs a term), the shares from the
H100 SXM's dense peaks: 67 TFLOP/s f32 outside the tensor cores (TF32 is
off, as the port's plain versions run) and 989 TFLOP/s bf16. One JSON line
per (width, dtype, route) with the JAX script's keys, ``route``, ``device``
and ``power_limit_w``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

H100_PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
H100_PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores (NVIDIA data sheet)
KERNEL_MAX_HIDDEN = 128  # csrc/nl_kernels.cu:548, models/nl.py:39-52


def nl_forward_flops_analytic(n_obs, m_act, *, terms=17, hidden=128, buf=4):
    """FLOPs of one NL forward (one sample), matrix products at 2 FLOPs a
    multiply-add: the reverse 2-layer GRU (hidden // 2) over the buffer, the
    encoder head, the trunk and its head, and ~10 FLOPs per (term, output)
    of the fourier combine; the elementwise nonlinearities are left out
    (bench.py ``nl_forward_flops_analytic``)."""
    h = hidden // 2
    flops, in_dim = 0, m_act
    for _ in range(2):
        flops += 2 * buf * (in_dim * 3 * h + h * 3 * h)
        in_dim = h
    flops += 2 * h * 2
    flops += 2 * ((2 * terms + n_obs + 2) * hidden + hidden * hidden + hidden * 2 * terms * n_obs)
    return flops + 10 * terms * n_obs


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def measure_one(env_name, hidden, dtype, batch, chain, reps, route="plain", device="cuda"):
    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models import count_params, make_model
    from neurallaplacecontrol_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    config = Config(nl_hidden_units=hidden, nl_compute_dtype=dtype)
    spec = make_env(env_name, dt=config.dt).spec
    model = make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high, config, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    params = model.init(g)
    apply = model.apply if route == "plain" else model.make_fused_planner_apply(params, config.dt)
    obs = torch.randn((batch, spec.n_obs), generator=g, device=device)
    buf = torch.randn((batch, config.action_buffer_size, spec.m), generator=g, device=device)
    ts = torch.full((batch, 1), config.dt, device=device)
    m = spec.m

    def chained(o, b):
        for _ in range(chain):
            o = torch.tanh(o + apply(params, o, b, ts))
            b = torch.cat([b[:, 1:], torch.tanh(o[:, None, :m])], dim=1)
        return o, b

    with torch.no_grad():
        o, b = chained(obs, buf)  # warm-up: the kernel's build, the allocator
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            o, b = chained(o, b)
        _sync(device)
    elapsed = (time.perf_counter() - t0) / reps
    flops = nl_forward_flops_analytic(spec.n_obs, spec.m, terms=config.nl_s_recon_terms, hidden=hidden,
                                      buf=config.action_buffer_size)
    achieved = flops * batch * chain / elapsed
    peak = H100_PEAK_BF16_FLOPS if dtype == "bfloat16" else H100_PEAK_F32_FLOPS
    return {
        "hidden": hidden,
        "dtype": dtype,
        "route": route,
        "batch": batch,
        "params": int(count_params(params)),
        "flops_per_forward": float(flops),
        "per_forward_us": elapsed / chain * 1e6,
        "forwards_per_sec": batch * chain / elapsed,
        "achieved_tflops": achieved / 1e12,
        "mfu_vs_dtype_peak": achieved / peak,
        "mfu_vs_bf16_peak": achieved / H100_PEAK_BF16_FLOPS,
        "finite": bool(torch.isfinite(o).all()),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="128,256,512,1024")
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--chain", type=int, default=50)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--env", default="oderl-cartpole")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from neurallaplacecontrol_tpu_torch.utils.device import card

    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    where = card(args.device)
    rows = []
    for hidden in (int(w) for w in args.widths.split(",")):
        for dtype in args.dtypes.split(","):
            routes = ["plain"] + (["kernel"] if hidden <= KERNEL_MAX_HIDDEN and dtype == "float32" else [])
            for route in routes:
                r = {**measure_one(args.env, hidden, dtype, args.batch, args.chain, args.reps, route, args.device),
                     **where}
                rows.append(r)
                print(json.dumps(r), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps({"batch": args.batch, "chain": args.chain, "rows": rows}, indent=1))
        print(f"wrote {args.json}", flush=True)
    return rows


if __name__ == "__main__":
    main()
