"""Where the chunk kernel's time goes, phase by phase, on the card.

    python3 chunk_probe.py

Builds a copy of `bloombee_tpu_torch/ops/cuda/csrc/paged_attention.cu`
and its headers, with a `%globaltimer` stamp (thread 0 of every CTA) at
each phase boundary of the chunk kernel, into the gitignored
`bloombee_tpu_torch/ops/cuda/_build/probe/`. It launches that copy on the
committed plan (`chunk_split`) once at the serving path's two B=1 shapes,
PR 1-4's B=4 table shape and a B=1 8000-token follow-up, and prints per
shape one JSON line of microseconds from the first CTA's start: the CTAs'
start spread (a second wave shows here), and the median / max over CTAs
of the prologue (lens and the rows' ranges), the first K/V tile's
arrival, the walk over the rest, the state store, the first cluster
barrier and the merge, and the kernel's end. Also each shape's device
time (warm and cold L2, as chip_smoke's `cuda_ms`) and the occupancy of
the plan's cluster size. Needs one CUDA device; the stamps cost a global
store each, so these times run a little above chip_smoke's.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from bloombee_tpu_torch.ops.cuda import build
from bloombee_tpu_torch.ops.cuda import paged_attention as pa

H, HKV, HD, PS = 32, 8, 128, 16
SLOTS = 12  # stamps per CTA
STAMPS = (  # (file, anchor, stamp inserted before it)
    ("paged_attention.cu",
     "  const HeadTile ht(gr, blockIdx.y);", "P(0);"),
    ("paged_rows.cuh", "  if (lo >= hi) {  // no row sees a key", "P(1);"),
    ("paged_rows.cuh", "    const int kbase = lo + t * TK",
     "if (t == 0) P(3);"),
    ("paged_rows.cuh", "  body.store(acc_c, ml_c);", "P(4);"),
    ("paged_rows.cuh", "  return true;\n}", "P(5);"),
    ("paged_attention.cu", "  for (int i = tid; i < nr * C; i += SNT) {",
     "P(6);"),
    ("paged_attention.cu",
     "  cluster.sync();  // no CTA leaves while a peer may still read it",
     "P(7);"),
)
PROBE = f"""
namespace bbsplit {{
__device__ unsigned long long bb_probe[8192 * {SLOTS}];
__device__ __forceinline__ void P(int k) {{
  if (threadIdx.x == 0) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const int cta =
        blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    bb_probe[cta * {SLOTS} + k] = t;
  }}
}}
}}  // namespace bbsplit
"""
ENTRY = f"""
extern "C" int bb_probe_read(void* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, bbsplit::bb_probe,
                                   sizeof(bbsplit::bb_probe));
}}
extern "C" int bb_probe_zero() {{
  static unsigned long long z[8192 * {SLOTS}];
  return (int)cudaMemcpyToSymbol(bbsplit::bb_probe, z, sizeof(z));
}}
extern "C" int bb_probe_clusters(int cl, int* out) {{
  auto kernel = chunk_kernel<__nv_bfloat16, 128>;
  const size_t smem = StageOf<__nv_bfloat16, 128>::smem;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, SNT, smem);
  cudaLaunchConfig_t cfg = {{}};
  cfg.gridDim = dim3(cl, 8, 8);
  cfg.blockDim = dim3(SNT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cl;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out + 1, kernel, &cfg);
}}
"""


def instrumented_library() -> ctypes.CDLL:
    """The chunk kernel's library built from a copy of its sources with
    the stamps, with the entry point's argument types."""
    dst = build.BUILD_DIR / "probe"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for src in [*build.CSRC.glob("*.cuh"), build.CSRC / "paged_attention.cu"]:
        shutil.copy(src, dst / src.name)
    rows = dst / "paged_rows.cuh"
    rows.write_text(rows.read_text().replace(
        '#include "paged_split.cuh"\n',
        '#include "paged_split.cuh"\n' + PROBE, 1))
    for name, anchor, stamp in STAMPS:
        path = dst / name
        text = path.read_text()
        if text.count(anchor) != 1:
            raise RuntimeError(f"{stamp} anchor not found once in {name}")
        path.write_text(text.replace(anchor, f"  {stamp}\n{anchor}"))
    main = dst / "paged_attention.cu"
    main.write_text(main.read_text() + ENTRY)
    so = dst / "probe.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(main)], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bb_paged_chunk_attention.argtypes = [
        *[vp] * 7, *[i32] * 10, ctypes.c_float, i32, vp]
    lib.bb_probe_read.argtypes = [vp]
    lib.bb_probe_clusters.argtypes = [i32, vp]
    return lib


def launch(lib, out, q, ks, vs, pt, lens, page_size, tree, scale, window,
           t_real) -> None:
    """One launch of the stamped kernel on the wrapper's plan."""
    b, t, h, hd = q.shape
    hkv = ks.shape[1]
    chunks, _ = pa.chunk_split(b, t, hkv, h // hkv, pt.shape[1])
    build.check(lib.bb_paged_chunk_attention(
        q.data_ptr(), ks.data_ptr(), vs.data_ptr(), pt.data_ptr(),
        lens.data_ptr(), None if tree is None else tree.data_ptr(),
        out.data_ptr(), b, t, h, hkv, hd, pt.shape[1],
        page_size, window, t_real, chunks, scale, 1,
        torch.cuda.current_stream().cuda_stream), "chunk probe")


def shapes(dev):
    """(label, chunk kernel args): the serving path's follow-up turn and
    tree verify (B=1, 128-page bucket), PR 1-4's B=4 table shape and a
    B=1 follow-up over 8000 tokens, bf16 at Llama-3-8B heads."""
    gen = torch.Generator(device=dev).manual_seed(5)
    i32 = dict(dtype=torch.int32, device=dev)
    ks, vs = cs._arena(gen, torch.bfloat16, 1024)
    out = []
    for label, b, t, t_real, length, pages, tree in (
        ("follow-up", 1, 32, 24, 1056, 128, False),
        ("tree verify", 1, 8, 8, 1040, 128, True),
        ("B=4 table", 4, 32, 24, 1032, 65, False),
        ("follow-up 8000", 1, 32, 24, 8000, 512, False),
    ):
        q = cs._unit(gen, (b, t, H, HD), torch.bfloat16)
        mask = (torch.stack([cs._tree(t, gen) for _ in range(b)]).to(dev)
                if tree else None)
        out.append((label, (q, ks, vs, cs._page_table(gen, b, pages, 1024),
                            torch.full((b,), length, **i32), PS, mask,
                            HD**-0.5, 0, t_real)))
    return out


def phases(stamps: np.ndarray) -> dict:
    """Per-phase medians and maxima (us) over the CTAs that stamped."""
    p = stamps.reshape(-1, SLOTS).astype(np.int64)
    p = p[p[:, 0] > 0]
    rel = np.where(p > 0, p - p[:, 0].min(), -1) / 1e3
    live = rel[rel[:, 3] >= 0]  # CTAs that walked a tile

    def stat(x):
        return [round(float(np.median(x)), 2), round(float(np.max(x)), 2)]

    return {
        "ctas": len(p), "start_spread": round(float(rel[:, 0].max()), 2),
        "prologue": stat(rel[:, 1] - rel[:, 0]),
        "first_tile": stat(live[:, 3] - live[:, 1]),
        "walk": stat(live[:, 4] - live[:, 3]),
        "store": stat(live[:, 5] - live[:, 4]),
        "barrier": stat(rel[:, 6] - rel[:, 5]),
        "merge": stat(rel[:, 7] - rel[:, 6]),
        "end": round(float(rel[:, 7].max()), 2),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chunk_probe: needs a CUDA device")
    lib = instrumented_library()
    stamps = np.zeros(8192 * SLOTS, dtype=np.uint64)
    print(cs.card_line(), flush=True)
    occ = np.zeros(2, dtype=np.int32)
    build.check(lib.bb_probe_clusters(pa.CHUNK_CLUSTER, occ.ctypes.data),
                "chunk probe occupancy")
    for label, args in shapes("cuda"):
        b, t, h = args[0].shape[:3]
        chunks, tiles = pa.chunk_split(b, t, HKV, h // HKV, args[3].shape[1])
        row = {"cluster": pa.CHUNK_CLUSTER, "ctas_per_sm": int(occ[0]),
               "max_active_clusters": int(occ[1]), "shape": label,
               "units": b * tiles * HKV, "chunks": chunks}
        out = torch.empty_like(args[0])
        row["ms"] = cs.cuda_ms(lambda: launch(lib, out, *args))
        row["cold_ms"] = cs.cuda_ms_cold(lambda: launch(lib, out, *args))
        torch.cuda.synchronize()
        lib.bb_probe_zero()
        launch(lib, out, *args)
        torch.cuda.synchronize()
        lib.bb_probe_read(stamps.ctypes.data)
        row.update(phases(stamps))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
