"""Whether Hopper's ``wgmma`` keeps ``mma.sync``'s bits where K1 sums in the
tensor cores' accumulator, on the card.

K1's HIGH-layout engine (``fused_bamp_decode.cu::high_pass``) sums each
output's k16 steps inside the mma accumulator: ``mma.sync.m16n8k16`` with
bf16 operands and an FP32 accumulator, k16 step after k16 step from zero.
The tensor cores truncate as they add into an accumulator (PERF.md, the
lessons of section 6), so another instruction may round those sums
otherwise.  Moving the
engine to ``wgmma`` (four warps issuing one m64nNk16 product, the A
operand from registers in ``mma.sync``'s fragment layout, B from shared
memory) keeps K1's results only if ``wgmma`` accumulating step after step
gives the same bits.  This script measures that: for ``--problems``
independent products of a 64 x 16K bf16 A and a 16K x N bf16 B (entries
normal times powers of two in [2^-8, 2^8], so the sums carry), it forms
the FP32 result as a chain of ``mma.sync`` (each of four warps its 16 rows,
as K1 does) and as a chain of ``wgmma.mma_async`` (A in registers, B in
shared memory in the no-swizzle K-major core-matrix layout, scale-d off
at the first step; the descriptor's two byte offsets both ways round,
``lbo_k`` and ``lbo_n``, only one of which reads B right), for K = 8 and
12 steps (K1's forward and adjoint at the
QPSK flagship) and N = 8 and 32, and prints the share of identical FP32
words and the largest difference of each from a float64 sum.

    for f in 0 1 2; do
        env PYTHONPATH=. python3 tests/torch_wgmma_bits.py --form $f
    done
    env PYTHONPATH=. python3 tests/torch_wgmma_bits.py

Prints one JSON line per (K, N) and the card's name and power limit.
Needs the card and ``nvcc``; imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from amp_sparc_spatialmodulation_tpu_torch.ops.kernels import build

SOURCE = r"""
#include <cuda_bf16.h>
#include <stdint.h>

// A (P, 64, 16 K) and B (P, 16 K, N) bf16 row-major; out (P, 64, N) FP32.
__device__ __forceinline__ unsigned pack(const __nv_bfloat16* p, int stride) {
  // two bf16: p[0] low, p[stride] high
  const unsigned short lo = __bfloat16_as_ushort(p[0]);
  const unsigned short hi = __bfloat16_as_ushort(p[stride]);
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

template <int N>
__device__ __forceinline__ void a_frag(unsigned (&a)[4],
                                       const __nv_bfloat16* A, int K16,
                                       int row0, int s, int g, int t) {
  const int ld = 16 * K16;
  const __nv_bfloat16* r0 = A + (row0 + g) * ld + 16 * s + 2 * t;
  const __nv_bfloat16* r1 = r0 + 8 * ld;
  a[0] = pack(r0, 1);
  a[1] = pack(r1, 1);
  a[2] = pack(r0 + 8, 1);
  a[3] = pack(r1 + 8, 1);
}

template <int N>
__global__ void mma_chain(const __nv_bfloat16* A, const __nv_bfloat16* B,
                          float* out, int K16) {
  const int p = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* Ap = A + static_cast<size_t>(p) * 64 * 16 * K16;
  const __nv_bfloat16* Bp = B + static_cast<size_t>(p) * 16 * K16 * N;
  float d[N / 8][4];
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
  for (int s = 0; s < K16; ++s) {
    unsigned a[4];
    a_frag<N>(a, Ap, K16, 16 * w, s, g, t);
    for (int j = 0; j < N / 8; ++j) {
      const __nv_bfloat16* b = Bp + (16 * s + 2 * t) * N + 8 * j + g;
      const unsigned b0 = pack(b, N), b1 = pack(b + 8 * N, N);
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float* o = out + static_cast<size_t>(p) * 64 * N;
  for (int j = 0; j < N / 8; ++j) {
    const int r = 16 * w + g, c = 8 * j + 2 * t;
    o[r * N + c] = d[j][0];
    o[r * N + c + 1] = d[j][1];
    o[(r + 8) * N + c] = d[j][2];
    o[(r + 8) * N + c + 1] = d[j][3];
  }
}

__device__ __forceinline__ uint64_t desc(const void* smem, unsigned lbo,
                                         unsigned sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  return (static_cast<uint64_t>((a & 0x3FFFF) >> 4)) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const unsigned (&a)[4], uint64_t db,
                                      int scale_d);

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4],
                                         const unsigned (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16],
                                          const unsigned (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__global__ void wgmma_chain(const __nv_bfloat16* A, const __nv_bfloat16* B,
                            float* out, int K16, unsigned lbo,
                            unsigned sbo) {
  // B of one k16 step in the no-swizzle K-major layout: core matrix (n8
  // block j, k half c) of 8 rows of 8 bf16 (16 B) at (j * 2 + c) * 64;
  // the k halves 128 B apart, the n8 blocks 256 B apart
  __shared__ __align__(128) __nv_bfloat16 sb[16 * N];
  const int p = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* Ap = A + static_cast<size_t>(p) * 64 * 16 * K16;
  const __nv_bfloat16* Bp = B + static_cast<size_t>(p) * 16 * K16 * N;
  float d[N / 2];
  for (int e = 0; e < N / 2; ++e) d[e] = 0.f;
  for (int s = 0; s < K16; ++s) {
    for (int i = threadIdx.x; i < 16 * N; i += blockDim.x) {
      const int k = i / N, n = i - k * N;  // B[16 s + k][n]
      const int j = n >> 3, c = k >> 3;
      sb[(j * 2 + c) * 64 + (n & 7) * 8 + (k & 7)] = Bp[(16 * s + k) * N + n];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    unsigned a[4];
    a_frag<N>(a, Ap, K16, 16 * w, s, g, t);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    wgmma<N>(d, a, desc(sb, lbo, sbo), s > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();
  }
  // accumulator: warp w rows 16 w + g (+ 8), n8 block j columns 8 j + 2 t
  float* o = out + static_cast<size_t>(p) * 64 * N;
  for (int j = 0; j < N / 8; ++j) {
    const int r = 16 * w + g, c = 8 * j + 2 * t;
    o[r * N + c] = d[4 * j];
    o[r * N + c + 1] = d[4 * j + 1];
    o[(r + 8) * N + c] = d[4 * j + 2];
    o[(r + 8) * N + c + 1] = d[4 * j + 3];
  }
}

extern "C" int run(int which, int N, const void* A, const void* B,
                   void* out, int P, int K16) {
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(A);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(B);
  float* o = static_cast<float*>(out);
  if (which == 0 && N == 8) mma_chain<8><<<P, 128>>>(a, b, o, K16);
  else if (which == 0 && N == 32) mma_chain<32><<<P, 128>>>(a, b, o, K16);
  // which 1: the core matrices along K 128 B apart as the descriptor's
  // leading byte offset (n8 blocks 256 B apart as its stride byte offset);
  // which 2: the two offsets the other way round
  else if (which >= 1 && which <= 2) {
    const unsigned lbo = which == 1 ? 128 : 256, sbo = which == 1 ? 256 : 128;
    if (N == 8) wgmma_chain<8><<<P, 128>>>(a, b, o, K16, lbo, sbo);
    else if (N == 32) wgmma_chain<32><<<P, 128>>>(a, b, o, K16, lbo, sbo);
    else return 1;
  } else {
    return 1;
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def library(out_dir: Path) -> ctypes.CDLL:
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "wgmma_bits.cu"
    src.write_text(SOURCE)
    lib = out_dir / "libwgmma_bits.so"
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    dll.run.argtypes = [i32, i32, p, p, p, i32, i32]
    dll.run.restype = i32
    return dll


def draws(dev, P, K16, N):
    """The inputs of one (K, N): A and B bf16, normal times powers of two
    in [2^-8, 2^8], from a fixed seed."""
    gen = torch.Generator(device=dev).manual_seed(1000 * K16 + N)

    def draw(*shape):
        x = torch.randn(*shape, generator=gen, device=dev)
        e = torch.randint(-8, 9, shape, generator=gen, device=dev)
        return (x * torch.pow(2.0, e.float())).bfloat16().contiguous()

    return draw(P, 64, 16 * K16), draw(P, 16 * K16, N)


SHAPES = [(8, 8), (8, 32), (12, 8), (12, 32)]
FORMS = {0: "mma", 1: "lbo_k", 2: "lbo_n"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--problems", type=int, default=4096)
    ap.add_argument("--out", type=Path, default=Path("build/wgmma_bits"))
    ap.add_argument("--form", type=int, choices=sorted(FORMS), default=None,
                    help="run one form and save its results (each form in "
                    "a process of its own: a descriptor that reads out of "
                    "bounds ends its process); without it, compare the "
                    "saved results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_wgmma_bits: no CUDA device")
    dev = torch.device("cuda")
    P = args.problems
    if args.form is not None:
        lib = library(args.out / f"form{args.form}")
        for K16, N in SHAPES:
            A, B = draws(dev, P, K16, N)
            o = torch.empty(P, 64, N, device=dev)
            rc = lib.run(args.form, N, A.data_ptr(), B.data_ptr(),
                         o.data_ptr(), P, K16)
            if rc != 0:
                raise RuntimeError(f"launch failed: {rc}")
            torch.cuda.synchronize()
            torch.save(o.cpu(), args.out / f"{FORMS[args.form]}_{K16}_{N}.pt")
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for K16, N in SHAPES:
        A, B = draws(dev, P, K16, N)
        exact = (A.double() @ B.double()).cpu()
        m = torch.load(args.out / f"mma_{K16}_{N}.pt")
        row = {"K16": K16, "N": N, "problems": P, "device": smi,
               "max_abs_err_mma": float((m.double() - exact).abs().max())}
        for name in ("lbo_k", "lbo_n"):
            f = args.out / f"{name}_{K16}_{N}.pt"
            if not f.exists():
                row[name] = "did not run"
                continue
            wg = torch.load(f)
            row[name] = {
                "identical_share": float((m.view(torch.int32)
                                          == wg.view(torch.int32))
                                         .float().mean()),
                "max_abs_mma_minus_wgmma": float((m - wg).abs().max()),
                "max_abs_err_wgmma": float((wg.double() - exact)
                                           .abs().max())}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
