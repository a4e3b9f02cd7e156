"""The linear-scan kernel against an earlier version of its source, on one
card: both built from source into libraries of their own and called
through their own ``ctypes.CDLL`` (the C interface ``ls_forward`` is the
same), timed in turns (old, new, new, old) by ``chip_smoke.time_ms`` at
the cases of ``chip_smoke.scan_kernel_phase``; per-phase cycles of both
from copies with a ``clock64()`` stamp after every block barrier; and,
with ``--ablate``, the times of copies of the new source with one part
cut out (their outputs are wrong; they time what each part costs).

    git show HEAD:src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu \\
        > build/old_linear_scan.cu
    python3 tools/scan_ab.py --old build/old_linear_scan.cu [--ablate]

Needs a CUDA card and nvcc; run from the root of a checkout."""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels.linear_scan import linear_scan as LSK  # noqa: E402
from repro_torch.kernels.nvcc import build_library  # noqa: E402

S = 256
# (label, B, K, V, decay_on_query, initial state, decay, bf16): the cases
# of chip_smoke.scan_kernel_phase at rwkv6-3b's shapes
CASES = [("train", 640, 64, 64, False, False, 1.0, True),
         ("eval", 2560, 64, 64, False, False, 1.0, True),
         ("ssd-K16", 800, 16, 64, True, True, 1.0, True),
         ("state", 640, 64, 64, False, True, 1.0, True),
         ("clip", 640, 64, 64, False, False, "clip", True),
         ("mixed", 640, 64, 64, False, False, "mixed", True),
         ("fp32", 640, 64, 64, False, True, 1.0, False)]
# --ablate: (label, [(text, replacement)]) on the new source
ABLATIONS = [
    ("no diagonal tiles",
     [("for (int e = tid; e < n_all; e += THREADS)",
       "for (int e = tid; e < 0; e += THREADS)")]),
    ("no q~, k~, q^ scaling",
     [("if (e < nu && t0 < Cr) {", "if (false) {")]),
    ("no tables", [("if (e < ntab) {", "if (false) {")]),
    ("no off-diagonal tiles", [("for (int e = w; e < ngt * 8; e += NP)",
                                "for (int e = w; e < 0; e += NP)")]),
    ("no state term",
     [("      if (mine) state_term(", "      if (0) state_term(")]),
    ("no P v", [("      if (mine) {\n        pair_values(",
                 "      if (0) {\n        pair_values(")]),
    ("no state update", [("        for (int e = tid - NY; e < K4 * V4; e += NS)\n"
                          "          update_tile(",
                          "        for (int e = tid - NY; e < 0; e += NS)\n"
                          "          update_tile(")]),
    ("no next-chunk cumulative sum",
     [("        cumsum(LW, C, K, LP, lt);\n      }", "      }")]),
    ("no v load", [("        for (int e = tid - NY; e < C * V4; e += NP)",
                    "        for (int e = tid - NY; e < 0; e += NP)")]),
]


def stamped(src: str) -> str:
    """The source with a clock64() stamp after every block barrier of
    linear_scan_kernel: thread 0 adds the cycles since its last stamp to
    g_cyc[k] for the k-th barrier in source order; ls_cycles reads and
    clears them."""
    head = ("#include <cuda_runtime.h>\n__device__ unsigned long long "
            "g_cyc[16];\n#define STAMP(k) if (threadIdx.x == 0) { long long "
            "now_ = clock64(); atomicAdd(&g_cyc[k], (unsigned long long)(now_"
            " - t_last_)); t_last_ = now_; }\n")
    i = src.index("linear_scan_kernel(")
    end = src.index("int launch(")
    body = src[i:end].replace("const int tid = threadIdx.x;",
                              "const int tid = threadIdx.x;\n  long long "
                              "t_last_ = clock64();", 1)
    count = iter(range(16))
    body = re.sub(r"__syncthreads\(\);",
                  lambda m: f"__syncthreads(); STAMP({next(count)});", body)
    tail = ('\nextern "C" int ls_cycles(unsigned long long* out) {\n'
            "  cudaMemcpyFromSymbol(out, g_cyc, sizeof(g_cyc));\n"
            "  unsigned long long z[16] = {0};\n"
            "  return (int)cudaMemcpyToSymbol(g_cyc, z, sizeof(z));\n}\n")
    return head + src[:i] + body + src[end:] + tail


def barrier_labels(src: str):
    """For each block barrier of the kernel, the first comment line since
    the barrier before it (the work that the barrier closes)."""
    i, end = src.index("linear_scan_kernel("), src.index("int launch(")
    out, first = [], None
    for line in src[i:end].splitlines():
        x = line.strip()
        if x.startswith("//") and first is None:
            first = x[2:].strip()[:60]
        if "__syncthreads();" in line:
            out.append(f"barrier {len(out)}: {first or ''}")
            first = None
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {CS.card_line()}; torch {torch.__version__}", flush=True)
    old_src, new_src = args.old.read_text(), LSK.SOURCES[0].read_text()
    work = Path(tempfile.mkdtemp(prefix="scan_ab_"))
    srcs = {"old": old_src, "new": new_src, "old+clock": stamped(old_src),
            "new+clock": stamped(new_src)}
    if args.ablate:
        for label, reps in ABLATIONS:
            s = new_src
            for a, b in reps:
                if a not in s:
                    raise SystemExit(f"ablation {label!r}: text not found")
                s = s.replace(a, b)
            srcs[label] = s
    files = {}
    for n, (key, s) in enumerate(srcs.items()):
        files[key] = work / f"v{n}.cu"
        files[key].write_text(s)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        futs = {k: pool.submit(build_library, f"ls_v{n}", [f], [],
                               work / "build")
                for n, (k, f) in enumerate(files.items())}
        libs = {}
        for k, f in futs.items():
            lib = ctypes.CDLL(str(f.result()))
            lib.ls_forward.argtypes = [ctypes.c_void_p] * 8 + \
                [ctypes.c_int] * 7 + [ctypes.c_void_p]
            lib.ls_forward.restype = ctypes.c_int
            libs[k] = lib
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def inputs(B, K, V, doq, with_s0, decay, bf16):
        dev, dt = "cuda", torch.bfloat16 if bf16 else torch.float32
        gen = torch.Generator(device=dev).manual_seed(6)
        q, k = (torch.randn(B, S, K, generator=gen, device=dev).to(dt)
                for _ in range(2))
        v = torch.randn(B, S, V, generator=gen, device=dev).to(dt)
        if decay == "clip":
            logw = torch.full((B, S, K), -math.exp(4.0), device=dev)
        elif decay == "mixed":
            logw = -1e-3 * torch.exp(torch.randn(B, S, K, generator=gen,
                                                 device=dev))
            logw[..., 0::2] = -math.exp(4.0)
        else:
            logw = -decay * torch.exp(torch.randn(B, S, K, generator=gen,
                                                  device=dev))
        bonus = None if doq else 0.3 * torch.randn(B, K, generator=gen,
                                                   device=dev)
        s0 = (torch.randn(B, K, V, generator=gen, device=dev) if with_s0
              else None)
        return [q, k, v, logw, bonus, s0,
                torch.empty(B, S, V, device=dev, dtype=dt),
                torch.empty(B, K, V, device=dev)]

    def call(lib, t, B, K, V, doq, bf16):
        ptr = [None if x is None else x.data_ptr() for x in t]
        err = lib.ls_forward(*ptr, B, S, 128, K, V, int(doq), int(bf16),
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ls_forward returned {err}")

    print("ms per call (CUDA-graph replay, median of 21), in turns old new "
          "new old; |old - new| the largest difference of y and the state",
          flush=True)
    for label, B, K, V, doq, with_s0, decay, bf16 in CASES:
        t = inputs(B, K, V, doq, with_s0, decay, bf16)
        outs = []
        for key in ("old", "new"):
            call(libs[key], t, B, K, V, doq, bf16)
            torch.cuda.synchronize()
            outs.append((t[6].float().clone(), t[7].clone()))
        ms = [CS.time_ms(torch, lambda i, key=key: call(libs[key], t, B, K,
                                                        V, doq, bf16),
                         10 if B <= 640 else 4)[0]
              for key in ("old", "new", "new", "old")]
        dy = float((outs[0][0] - outs[1][0]).abs().max())
        ds = float((outs[0][1] - outs[1][1]).abs().max())
        print(f"{label:8s} B {B:5d} K {K:3d} V {V:3d}  old {ms[0]:.5f} "
              f"{ms[3]:.5f}  new {ms[1]:.5f} {ms[2]:.5f}  old/new "
              f"{(ms[0] + ms[3]) / (ms[1] + ms[2]):.3f}  |old - new| y "
              f"{dy:.3g} state {ds:.3g}", flush=True)
        if label == "train":
            train = (t, B, K, V, doq, bf16)
            if args.ablate:
                for a_label, _ in ABLATIONS:
                    a = CS.time_ms(torch, lambda i, k_=a_label: call(
                        libs[k_], t, B, K, V, doq, bf16), 10)[0]
                    print(f"  train without {a_label[3:]:28s} {a:.5f} ms "
                          f"(new {(ms[1] + ms[2]) / 2:.5f})", flush=True)
        del outs
    t, B, K, V, doq, bf16 = train
    print(f"cycles between block barriers at the train shape (thread 0's "
          f"clock64, summed over blocks and chunks, per chunk-row)")
    for key, src in (("old+clock", old_src), ("new+clock", new_src)):
        lib = libs[key]
        lib.ls_cycles.argtypes = [ctypes.c_void_p]
        buf = (ctypes.c_ulonglong * 16)()
        call(lib, t, B, K, V, doq, bf16)
        torch.cuda.synchronize()
        lib.ls_cycles(buf)
        call(lib, t, B, K, V, doq, bf16)
        torch.cuda.synchronize()
        lib.ls_cycles(buf)
        labels = barrier_labels(src)
        cyc = [int(buf[i]) for i in range(len(labels))]
        rows = B * (S // 128)
        print(f"{key[:3]}: {sum(cyc) / rows:.0f} cycles per chunk-row")
        for lab, x in zip(labels, cyc):
            print(f"  {x / rows:9.0f}  {x / max(sum(cyc), 1):.4f}  {lab}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
