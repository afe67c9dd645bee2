#!/usr/bin/env python3
"""Where the megakernel's time goes: per-lane clock64() counters of each
phase of a trip, on the fixture at B=1024 in float32 (the mega path's
shapes), on one NVIDIA GPU.

Builds a copy of ``cilqr_tpu_torch/csrc/megasolve.cu`` with counters
inserted at fixed points of ``mega_kernel`` (the shipped source stays
uninstrumented) into ``cilqr_tpu_torch/_build/profile/``, launches it
twice, and prints for the first two exit blocks (the fixture tiles by 256,
so they are the long and the short block) the mean and max over their
lanes of each phase, in kc (units of 1,024 SM cycles):

  relinearize  Jacobians, cost derivatives and Riccati pass (aidx == 0)
  derivs       the per-knot Jacobians and derivatives within it
  rollout      the closed-loop rollout (one thread)
  cost         the candidate's cost (lane scans and knot sums)
  vote         from a lane's exit vote to the cluster's decision: waiting
               for the slowest lane of the block, and the barrier
  loop         the whole trip loop

Run from the repository root:  python3 tools/profile_megakernel.py
"""

import ctypes
import os
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
B = 1024
ROWS = ("relinearize", "derivs", "rollout", "cost", "vote", "loop")

# (anchor in megasolve.cu, text that replaces it); each anchor must occur
# exactly once
PATCHES = (
    ("  int cur = 0, trips = 0;\n",
     "  int cur = 0, trips = 0;\n"
     "  long long cyc[6] = {0, 0, 0, 0, 0, 0};\n"
     "  const long long p_loop = clock64();\n"),
    ("      if (aidx == 0) {\n        ++relins;",
     "      long long p_relin = clock64();\n"
     "      if (aidx == 0) {\n        ++relins;"),
    ("        gnorm_done = gnorm < K(GNORM_MIN) && lam < K(GNORM_LAM);\n"
     "      }\n",
     "        gnorm_done = gnorm < K(GNORM_MIN) && lam < K(GNORM_LAM);\n"
     "      }\n"
     "      cyc[0] += clock64() - p_relin;\n"),
    ("        if (g.tid == 0) rollout(p, tr, gains, cand, alpha);\n"
     "        g.sync();\n",
     "        long long p_roll = clock64();\n"
     "        if (g.tid == 0) rollout(p, tr, gains, cand, alpha);\n"
     "        g.sync();\n"
     "        cyc[2] += clock64() - p_roll;\n"
     "        const long long p_cost = clock64();\n"),
    ("                  sel + (1 - cur) * NSD, acc);\n",
     "                  sel + (1 - cur) * NSD, acc);\n"
     "        cyc[3] += clock64() - p_cost;\n"),
    ("    ++trips;\n",
     "    const long long p_vote = clock64();\n    ++trips;\n"),
    ("    if (!any) break;",
     "    cyc[4] += clock64() - p_vote;\n    if (!any) break;"),
    ("      AT(p.is, 3) = relins;",
     "      AT(p.is, 3) = relins;\n"
     "      cyc[5] = clock64() - p_loop;\n"
     "      for (int i = 0; i < 6; ++i) AT(p.is, 4 + i) = (int)(cyc[i] >> 10);"),
    # the derivatives' share of the relinearization, inside backward()
    ("                         T* chunk, T* gains, Rn<T> lam, Rn<T>& dV0,\n"
     "                         Rn<T>& dV1, Rn<T>& gnorm) {",
     "                         T* chunk, T* gains, Rn<T> lam, Rn<T>& dV0,\n"
     "                         Rn<T>& dV1, Rn<T>& gnorm,\n"
     "                         long long& p_derivs) {"),
    ("    const int t = hi - g.tid;\n    if (t >= lo) {",
     "    const int t = hi - g.tid;\n    const long long p_d = clock64();\n"
     "    if (t >= lo) {"),
    ("    g.sync();\n    for (int t2 = hi; t2 >= lo; --t2) {",
     "    g.sync();\n    p_derivs += clock64() - p_d;\n"
     "    for (int t2 = hi; t2 >= lo; --t2) {"),
    ("        backward(p, g, b, tr, tab, sel + cur * NSD, rs, un, gains, "
     "lam, dV0,\n                 dV1, gnorm);",
     "        backward(p, g, b, tr, tab, sel + cur * NSD, rs, un, gains, "
     "lam, dV0,\n                 dV1, gnorm, cyc[1]);"),
)


def instrumented_library(build):
    """Compile the instrumented copy of megasolve.cu; returns the loaded
    library."""
    src = (build.CSRC / "megasolve.cu").read_text()
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once in megasolve.cu: "
                               f"{anchor!r}")
        src = src.replace(anchor, text)
    out_dir = build.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "megasolve_profile.cu"
    cu.write_text(src)
    lib = out_dir / "libmegasolve_profile.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
           str(build.CSRC), "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    so.solve_batch_mega_f32.argtypes = build._SIGNATURES["solve_batch_mega"]
    so.solve_batch_mega_f32.restype = ctypes.c_int
    return so


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_megakernel: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import cilqr_tpu_torch as P
    from cilqr_tpu_torch.kernels import _build, megasolve as M

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    lib = instrumented_library(_build)

    cfg = P.PlannerConfig()
    ilqr, veh, dt = cfg.ilqr, cfg.vehicle, cfg.delta_t
    g, s, cons = P.convert.load_fixture(dtype=torch.float32, device="cuda",
                                        batch=B)
    ops = M._operands(g, s, cons, ilqr, veh, dt, None, M.NB)[0]
    N, KC, S = ops[0].shape[0], ops[3].shape[1], ops[6].shape[1]
    T = N - 1
    c = M._constants(ilqr, veh, dt, T)
    D = len(c.offs)
    kw = dict(dtype=torch.float32, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    istate = torch.zeros((4 + len(ROWS), B), **i32)
    trips = torch.empty((B // M.NB,), **i32)
    outs = [torch.empty((N, 6, B), **kw), torch.empty((T, 2, B), **kw),
            torch.empty((6, B), **kw), istate, trips,
            torch.empty((B, 2, N * 6 + T * 2), **kw),
            torch.empty((B, T * 14), **kw), torch.empty((B, N * 2 * D), **kw),
            torch.empty((B, 2, N * 2 * D), **i32)]
    # host arrays the launch reads, kept alive across it
    cst = [getattr(c, name) for name in M.CONSTANTS]
    host = [(ctypes.c_double * len(cst))(*cst),
            (ctypes.c_double * D)(*c.offs),
            (ctypes.c_double * len(c.alphas))(*c.alphas),
            (ctypes.c_void_p * (len(ops) + len(outs)))(
                *(t.data_ptr() for t in list(ops) + outs))]
    for rep in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = lib.solve_batch_mega_f32(
            N, B, KC, S, D, len(c.alphas), c.max_iter, M.NB,
            *(ctypes.cast(a, ctypes.c_void_p) for a in host),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        end.record()
        torch.cuda.synchronize()
        if err:
            sys.exit(f"profile_megakernel: launch failed, cudaError_t {err}")
        print(f"run {rep}: instrumented kernel {start.elapsed_time(end):.2f} "
              f"ms", flush=True)
    ist = istate.cpu().long()
    print(f"block trips {trips.tolist()}")
    for blk in (0, 1):
        lanes = slice(blk * M.NB, (blk + 1) * M.NB)
        print(f"block {blk}: {int(trips[blk])} trips; lane trips mean "
              f"{float(ist[2, lanes].float().mean()):.2f}, relinearizations "
              f"mean {float(ist[3, lanes].float().mean()):.2f}; per lane, "
              f"kc (1,024 cycles) mean / max:")
        for i, name in enumerate(ROWS):
            row = ist[4 + i, lanes]
            print(f"  {name:12s} {float(row.float().mean()):10.0f} "
                  f"{int(row.max()):10d}")


if __name__ == "__main__":
    os.chdir(ROOT)
    main()
