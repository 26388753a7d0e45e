"""Design A/Bs of the hand-written kernels, timed on the card.

Run from the repository root on a machine with a Hopper card::

    python3 -m paddle_tpu_torch.kernels.design_ab fused_bwd paged

Each experiment of ``EXPERIMENTS`` names a kernel library, the call it
times (``chip_smoke.py``'s own shapes) and a set of variants. A variant
is a list of text substitutions on ``csrc/<library>.cu`` as it stands:
the kernel as it was before a design choice, or with one part switched
off to see what that part costs (names starting ``instrument_``: their
output is wrong on purpose and is not checked). For every variant the
sources are copied to ``_build/ab/<experiment>/<variant>/``, patched and
built with the library's own ``nvcc`` flags and ctypes signatures (all
builds at once); each build is held against the plain version on the
call (largest error, bitwise equal run to run), then the base library
and the variants are timed in turns (base, v1, .., vn, vn, .., v1, base,
twice) with ``chip_smoke.Timer``. Results, with the card's name and power
limit, go to stdout and ``chiprun_out/design_ab.json``. A substitution
that no longer matches the source raises: the experiments describe the
current kernels (``tests/test_torch_paged_split.py`` checks they still
apply).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List, Tuple

from . import _build

Subs = List[Tuple[str, str]]

_FUSED_MMA_SPLIT = """\
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (cg + NG * jj < ND) tf32::mma(f[jj], al, bh[jj]);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (cg + NG * jj < ND) tf32::mma(fb[jj], ah, bh[jj]);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (cg + NG * jj < ND) tf32::mma(f[jj], ah, bl[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc2[jj][e] += fb[jj][e] + f[jj][e];"""
_FUSED_MMA_ONE = """\
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (cg + NG * jj < ND) tf32::mma(f[jj], al, bh[jj]);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (cg + NG * jj < ND) tf32::mma(f[jj], ah, bl[jj]);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          if (cg + NG * jj < ND) tf32::mma(f[jj], ah, bh[jj]);
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc2[jj][e] += f[jj][e];"""

_PAGED_COPY = """\
  const int per_row = A.D / kW;
  for (int idx = lane; idx < kTile * per_row; idx += 32) {
    const int r = idx / per_row, col = (idx % per_row) * kW;
    const int t = t0 + r;
    const bool ok = t < t_end;
    long long at = 0;
    if (ok) {
      int blk = A.tables[(long long)b * A.max_blocks + t / A.block_size];
      blk = blk < 0 ? 0 : (blk >= A.n_blocks ? A.n_blocks - 1 : blk);
      const long long row =
          ((long long)blk * A.block_size + t % A.block_size) * A.H + h;
      at = row * A.D + col;
    }"""
_PAGED_COPY_ONCE = """\
  long long mine = -1;
  const int t = t0 + lane;
  if (t < t_end) {
    int blk = A.tables[(long long)b * A.max_blocks + t / A.block_size];
    blk = blk < 0 ? 0 : (blk >= A.n_blocks ? A.n_blocks - 1 : blk);
    mine = (((long long)blk * A.block_size + t % A.block_size) * A.H + h) *
           A.D;
  }
  const int per_row = A.D / kW;
#pragma unroll
  for (int i = 0; i < 32 * E / kW; ++i) {  // kTile * per_row / 32 at most
    const int idx = lane + 32 * i;
    if (idx >= kTile * per_row) break;
    const int r = idx / per_row, col = (idx % per_row) * kW;
    const long long row = __shfl_sync(0xffffffffu, mine, r);
    const bool ok = row >= 0;
    const long long at = ok ? row + col : 0;"""
_PAGED_TICKET = """\
    __syncthreads();
    if (threadIdx.x == 0) last_s = ticket(A.tickets + bh) == n_ch - 1;
    __syncthreads();
    if (!last_s) continue;
    if (d < D) {"""
_PAGED_TICKET_FENCES = """\
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last_s = atomicAdd(A.tickets + bh, 1) == n_ch - 1;
    __syncthreads();
    if (!last_s) continue;
    __threadfence();
    if (d < D) {"""
_PAGED_MERGE_ONE_ROUND = """\
      // the first 8 chunks' (M, L, acc) in one round of loads, then the
      // merge in chunk order: M = max, then L and acc under M
      const float* pc = A.part + bh * A.max_chunks * (D + 2);
      float mk[8], lk[8], ak[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= n_ch) break;
        const float* pk = pc + k * (D + 2);
        mk[k] = __ldcg(pk + D);
        lk[k] = __ldcg(pk + D + 1);
        ak[k] = __ldcg(pk + d);
      }
      float Mx = kNegInf;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < n_ch) Mx = fmaxf(Mx, mk[k]);
      for (int k = 8; k < n_ch; ++k)
        Mx = fmaxf(Mx, __ldcg(pc + k * (D + 2) + D));
      float Lx = 0.f, ox = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k >= n_ch) break;
        const float cw = expf(mk[k] - Mx);
        Lx += lk[k] * cw;
        ox += ak[k] * cw;
      }
      for (int k = 8; k < n_ch; ++k) {
        const float* pk = pc + k * (D + 2);
        const float cw = expf(__ldcg(pk + D) - Mx);
        Lx += __ldcg(pk + D + 1) * cw;
        ox += __ldcg(pk + d) * cw;
      }
"""
_PAGED_MERGE_TWO_ROUNDS = """\
      const float* pc = A.part + bh * A.max_chunks * (D + 2);
      float Mx = kNegInf;
#pragma unroll 8
      for (int k = 0; k < n_ch; ++k)
        Mx = fmaxf(Mx, __ldcg(pc + k * (D + 2) + D));
      float Lx = 0.f, ox = 0.f;
#pragma unroll 8
      for (int k = 0; k < n_ch; ++k) {
        const float* pk = pc + k * (D + 2);
        const float cw = expf(__ldcg(pk + D) - Mx);
        Lx += __ldcg(pk + D + 1) * cw;
        ox += __ldcg(pk + d) * cw;
      }
"""

# experiment -> (library, call, {variant: substitutions}, {variant: chunk})
EXPERIMENTS: Dict[str, dict] = {
    "fused_bwd": {
        "library": "flash_attention",
        "call": "fused_bwd_seq128",
        "variants": {
            # the split of PRs 4-6: lo rounded too
            "rna_split": [("static constexpr bool kFast = true;",
                           "static constexpr bool kFast = false;")],
            # K and V resident in 32-key sub-tiles, one block per SM
            "keys32_resident_one_block": [(
                "  static constexpr int BK = 16;\n"
                "  static constexpr int NSLOT = 2;\n"
                "  static constexpr int kBlocks = D <= 64 ? 2 : 1;",
                "  static constexpr int BK = 32;\n"
                "  static constexpr int NSLOT = R / BK;\n"
                "  static constexpr int kBlocks = 1;")],
            "ring3": [("  static constexpr int NSLOT = 2;",
                       "  static constexpr int NSLOT = 3;")],
            # S and dP one after the other, not interleaved
            "separate_s_dp": [(
                "      score_tiles2<D, NT, LD, kFast>(s, dp, Qs, Ks, dOs, Vs,"
                " m0);\n",
                "      score_tile<D, NT, LD, kFast>(s, Qs, m0, Ks);\n"
                "      score_tile<D, NT, LD, kFast>(dp, dOs, m0, Vs);\n")],
            # phase 2 with one fresh tile for all three passes
            "one_phase2_accumulator": [(_FUSED_MMA_SPLIT, _FUSED_MMA_ONE)],
            "phase2_loop_rolled": [(
                "#pragma unroll\n      for (int u = 0; u < 4; ++u) {",
                "#pragma unroll 1\n      for (int u = 0; u < 4; ++u) {")],
        },
    },
    "paged": {
        "library": "paged_attention",
        "call": "paged_decode",
        "variants": {
            # each lane reads one token's table entry, the copies take it
            # by shuffle (one round of table reads, not one per copy)
            "table_once_per_token": [
                (_PAGED_COPY, _PAGED_COPY_ONCE),
                ("template <bool kVec>\n__device__ __forceinline__ void "
                 "copy_tile(", "template <int E, bool kVec>\n__device__ "
                 "__forceinline__ void copy_tile("),
                ("copy_tile<kVec>(A, b, h, t0, t_end, Ks, Vs, LDK);",
                 "copy_tile<E, kVec>(A, b, h, t0, t_end, Ks, Vs, LDK);")],
            # every thread fences; atomicAdd without acquire-release
            "fence_every_thread": [(_PAGED_TICKET, _PAGED_TICKET_FENCES)],
            # the merge's loads in two rounds (max, then sums)
            "merge_two_rounds": [(_PAGED_MERGE_ONE_ROUND,
                                  _PAGED_MERGE_TWO_ROUNDS)],
            # 2 warps, chunks of 64 tokens
            "two_warps_chunk64": [("constexpr int kSplitWarps = 4;",
                                   "constexpr int kSplitWarps = 2;")],
            # timing only: every chunk writes its own output, no merge
            "instrument_no_merge": [("    if (n_ch == 1) {",
                                     "    if (true) {")],
            # timing only: tiles copied, not computed on
            "instrument_no_compute": [(
                "    if (t0 < t_end) {\n"
                "      const int n = min(kTile, t_end - t0);",
                "    if (false) {\n"
                "      const int n = min(kTile, t_end - t0);")],
        },
        "chunk": {"two_warps_chunk64": 64},
    },
}


def patched(library: str, subs: Subs) -> str:
    """csrc/<library>.cu with ``subs`` applied; each old text must occur
    exactly once."""
    src = (_build.CSRC / f"{library}.cu").read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"{library}: substitution does not match the "
                             f"source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def _build_variant(library: str, exp: str, name: str, subs: Subs):
    out = _build.BUILD_DIR / "ab" / exp / name
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for f in _build.CSRC.iterdir():
        shutil.copy(f, out / f.name)
    (out / f"{library}.cu").write_text(patched(library, subs))
    so = out / f"{library}.so"
    proc = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                             str(so), str(out / f"{library}.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, so


def _load(library: str, so) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build.SOURCES[library].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _call(torch, cs, name: str):
    """(run, reference outputs) of an experiment's call."""
    import numpy as np
    from . import flash_attention as fa
    from . import paged_attention as pa
    rng = np.random.default_rng(cs.SEED)
    if name == "fused_bwd_seq128":
        t, kw = cs.flash_inputs(torch, rng, 32, 128, 128, 12, 64, True,
                                False, 0.1)
        kw["causal"] = False
        out, lse = fa.flash_fwd(t["q"], t["k"], t["v"], **kw)
        args = (t["q"], t["k"], t["v"], t["dout"], lse,
                cs.flash_delta(torch, t["dout"], out, True))
        return (lambda: fa.flash_bwd_fused(*args, **kw),
                fa.flash_bwd_plain(*args, **kw))
    lens = [1, 17, 64, 100, 128, 255, 256, 333, 400, 511, 512, 640, 777,
            900, 1000, 1024]
    t, _ = cs.paged_inputs(torch, rng, len(lens), None, 12, 64, 16, lens)
    args = (t["q"], t["k"], t["v"], t["tbl"], t["lens"])
    return ((lambda: (pa.paged_attention(*args),)),
            (pa.paged_attention_plain(*args),))


def run(torch, cs, exp: str) -> dict:
    from . import paged_attention as pa
    spec = EXPERIMENTS[exp]
    library = spec["library"]
    base = _build.build_all([library])[library]
    procs = {n: _build_variant(library, exp, n, subs)
             for n, subs in spec["variants"].items()}
    libs = {"base": base}
    for n, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{exp}/{n}: nvcc failed:\n{log[-4000:]}")
        libs[n] = _load(library, so)
    chunks = dict(spec.get("chunk", {}))
    default_chunk = pa.CHUNK_TOKENS

    def use(n):
        _build._libs[library] = libs[n]
        pa.CHUNK_TOKENS = chunks.get(n, default_chunk)

    call, ref = _call(torch, cs, spec["call"])
    result = {"checks": {}, "ms": {n: [] for n in libs}}
    for n in libs:
        use(n)
        got, again = call(), call()
        torch.cuda.synchronize()
        result["checks"][n] = {
            "max_abs_err": max(float((g - r).abs().max())
                               for g, r in zip(got, ref)),
            "bitwise_run_to_run": all(torch.equal(x, y)
                                      for x, y in zip(got, again))}
        if not n.startswith("instrument_") and not (
                result["checks"][n]["max_abs_err"] <= 1e-4
                and result["checks"][n]["bitwise_run_to_run"]):
            raise AssertionError(f"{exp}/{n}: {result['checks'][n]}")
    timer = cs.Timer(torch)
    order = list(libs) + list(libs)[::-1]
    for _ in range(2):
        for n in order:
            use(n)
            result["ms"][n].append(timer(call))
    use("base")
    return result


def main(argv: List[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("design_ab: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    report = {"card": card}
    print(card)
    for exp in argv or list(EXPERIMENTS):
        report[exp] = run(torch, cs, exp)
        print(exp, json.dumps(report[exp]))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "design_ab.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
