"""Time builds of the forward kernel's source against each other, in turns, on one GPU.

Each ``--variant NAME:SOURCE[:CONST=VALUE,...]`` is a copy of a kernel source
(``csrc/nl_kernels.cu`` of this checkout or of another tree) with the named
``constexpr int`` constants set, built by nvcc with the port's flags into
``--out``/NAME and loaded with ctypes. Every variant runs the forward on the
tracked cartpole d1 checkpoint at each of ``--rows``, is held to the plain
forward (|got - exp| / (1 + |exp|) < 1e-3, the card tests' limit), and is
timed by CUDA events: ``graph_ms`` over 20 launches captured in one CUDA graph,
``eager_ms`` over 20 launches. ``--rounds`` rounds time the variants in turns,
the order reversed every other round. One JSON line per measurement, also
appended to ``--out``/results.jsonl:

    python3 scripts/bench_resident_forward.py \\
        --variant c2:neurallaplacecontrol_tpu_torch/csrc/nl_kernels.cu \\
        --variant c3:neurallaplacecontrol_tpu_torch/csrc/nl_kernels.cu:kGruCtas=2

A source that takes the constants another way than its own declarations
refuses the variant (the substitution must match once).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from neurallaplacecontrol_tpu_torch.models import make_model  # noqa: E402
from neurallaplacecontrol_tpu_torch.ops import nl_cuda  # noqa: E402
from neurallaplacecontrol_tpu_torch.ops import pallas_nl as tnl  # noqa: E402
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name  # noqa: E402

ENV, N_OBS, M, HIGH = "oderl-cartpole", 5, 1, 3.0
DT, TERMS, A = 0.05, 17, 4
TOL = 1e-3
LAUNCHES = 20


def variant_source(spec: str, out: Path) -> tuple[str, Path]:
    """NAME:SOURCE[:CONST=VALUE,...] -> (NAME, the edited copy of SOURCE under out/NAME)."""
    name, src, *rest = spec.split(":")
    text = (ROOT / src).read_text()
    for item in (rest[0].split(",") if rest else []):
        const, value = item.split("=")
        text, n = re.subn(rf"constexpr int {const} = [^;]+;", f"constexpr int {const} = {value};", text)
        if n != 1:
            raise ValueError(f"variant {name}: constexpr int {const} matched {n} times in {src}")
    d = out / name
    d.mkdir(parents=True, exist_ok=True)
    path = d / "nl_kernels.cu"
    path.write_text(text)
    return name, path


def build(path: Path) -> tuple[ctypes.CDLL, list]:
    lib = path.parent / "libnl_kernels.so"
    cmd = [nl_cuda.find_nvcc(), *nl_cuda.NVCC_FLAGS, "-o", str(lib), str(path)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {proc.stderr[-4000:]}")
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "nl_forward_kernel" in ln or ("registers" in ln) or "spill" in ln]
    so = ctypes.CDLL(str(lib))
    so.nl_forward_launch.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    so.nl_forward_launch.restype = ctypes.c_int
    so.nl_forward_plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    so.nl_forward_plan.restype = ctypes.c_int
    so.nl_init.restype = ctypes.c_int
    so.nl_error_string.argtypes = [ctypes.c_int]
    so.nl_error_string.restype = ctypes.c_char_p
    return so, ptxas


def check(so, name: str, code: int) -> None:
    if code:
        raise RuntimeError(f"{name}: {so.nl_error_string(code).decode()} ({code})")


def launcher(so, obs, acts, hopper, out):
    dims = (obs.shape[0], N_OBS, A, M, 64, 128, N_OBS, TERMS, hopper.numel())
    ints = (ctypes.c_int * 9)(*dims)
    ptrs = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in (obs, acts, hopper, out)))

    def run():
        check(so, "nl_forward_launch", so.nl_forward_launch(ptrs, 4, ints, 9, torch.cuda.current_stream().cuda_stream))

    info = (ctypes.c_longlong * 10)()
    if so.nl_forward_plan(ints, 9, info) != 0:
        raise RuntimeError(f"the library does not plan the resident kernel at dims {dims}")
    return run, {"tile_rows": info[0], "smem_bytes": info[5], "ctas": info[7], "cluster": info[8]}


def timed(run) -> dict:
    for _ in range(3):
        run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        run()
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / LAUNCHES
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAUNCHES):
            run()
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return {"graph_ms": start.elapsed_time(end) / LAUNCHES, "eager_ms": eager}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", required=True)
    parser.add_argument("--rows", default="1000,20000,32768")
    parser.add_argument("--check_rows", default="1,7,9,17,1001,4241,20003",
                        help="rows held to the plain forward but not timed")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--out", default="chiprun_out/bench_resident_forward")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    results = open(out_dir / "results.jsonl", "a")

    def emit(rec):
        line = json.dumps({**rec, "card": card})
        print(line, flush=True)
        results.write(line + "\n")
        results.flush()

    path = ROOT / "artifacts" / "checkpoints" / model_checkpoint_name("nl", ENV, 1, "exp", 0, True)
    fused = make_model("nl", ENV, N_OBS, M, HIGH, device=device).make_fused_planner_apply(
        load_pytree(path, device=device), DT)
    rows_timed = [int(r) for r in args.rows.split(",")]
    rows_all = sorted(set(rows_timed) | {int(r) for r in args.check_rows.split(",")})
    rng = np.random.default_rng(20)
    obs_all = torch.tensor(rng.standard_normal((max(rows_all), N_OBS)), dtype=torch.float32, device=device)
    acts_all = torch.tensor(rng.uniform(-HIGH, HIGH, (max(rows_all), A * M)), dtype=torch.float32, device=device)

    libs = {}
    for spec in args.variant:
        name, src = variant_source(spec, out_dir)
        try:
            so, ptxas = build(src)
            check(so, "nl_init", so.nl_init())
        except RuntimeError as e:
            emit({"variant": name, "error": str(e)})
            continue
        libs[name] = so
        emit({"variant": name, "ptxas": ptxas})
        for rows in rows_all:
            obs, acts = obs_all[:rows], acts_all[:rows]
            got = torch.full((rows + 8, N_OBS), 7.0, device=device)
            run, plan = launcher(so, obs, acts, fused.hopper, got)
            run()
            exp = tnl.nl_forward_plain(obs, acts, fused.packed, N_OBS, M)
            torch.cuda.synchronize()
            err = float(((got[:rows] - exp).abs() / (1.0 + exp.abs())).max())
            guard = bool((got[rows:] == 7.0).all())
            emit({"variant": name, "rows": rows, "rel_err": err, "ok": err < TOL and guard, "guard_rows_kept": guard,
                  **plan})
    for rnd in range(args.rounds):
        order = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
        for rows in rows_timed:
            obs, acts = obs_all[:rows], acts_all[:rows]
            out = torch.empty((rows, N_OBS), device=device)
            for name in order:
                run, plan = launcher(libs[name], obs, acts, fused.hopper, out)
                emit({"variant": name, "rows": rows, "round": rnd, **timed(run), **plan})
    results.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
