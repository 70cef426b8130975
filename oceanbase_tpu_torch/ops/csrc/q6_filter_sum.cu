// Fused TPC-H Q6 filter + exact sum, hand-written for Hopper (sm_90a).
//
// Replaces oceanbase_tpu/ops/scan_kernels.py::q6_filter_sum (Pallas body
// _q6_kernel, pallas_call at scan_kernels.py:111).
//
// What it computes: the sum over rows i of price[i] * disc[i] where
//   ship_lo <= ship[i] < ship_hi, disc_lo <= disc[i] <= disc_hi,
//   qty[i] < qty_hi and live[i] != 0.
// Five int32 columns of length n in; one int64 out (scale-4 fixed point
// for TPC-H's scale-2 price and discount).
//
// What bounds it: memory.  Every row is read once, 5 x 4 = 20 bytes, for
// a handful of integer operations.  At TPC-H SF1 (~6.0M lineitem rows,
// ~120 MB) the least time is about 36 us at the H100's 3.35 TB/s.
//
// Design: each byte is streamed once.  A grid-stride loop where every
// thread loads 16 bytes (one int4) from each column when all five
// pointers are 16-byte aligned; the ragged tail, and unaligned inputs,
// go element by element.  Products and partial sums are int64: the TPU
// kernel's 16-bit hi/lo split works around a 32-bit vector unit that
// Hopper does not have.  A warp-shuffle reduce, then a shared-memory
// block reduce, then ONE atomicAdd per block into the int64 output that
// the caller zeroes.  Integer addition is associative, so the result is
// exact and the same on every run.  The grid fills every SM once at full
// occupancy and is never larger than the data needs.
//
// Interface: plain C, loaded with ctypes.  The launch goes on the
// caller's stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Q6Bounds {
  int ship_lo, ship_hi, disc_lo, disc_hi, qty_hi;
};

__device__ __forceinline__ long long q6_row(int ship, int disc, int qty,
                                            int price, int live,
                                            const Q6Bounds& b) {
  const bool keep = (ship >= b.ship_lo) & (ship < b.ship_hi) &
                    (disc >= b.disc_lo) & (disc <= b.disc_hi) &
                    (qty < b.qty_hi) & (live != 0);
  return keep ? static_cast<long long>(price) * static_cast<long long>(disc)
              : 0LL;
}

__device__ __forceinline__ long long q6_row4(const int4& s, const int4& d,
                                             const int4& q, const int4& p,
                                             const int4& l,
                                             const Q6Bounds& b) {
  return q6_row(s.x, d.x, q.x, p.x, l.x, b) +
         q6_row(s.y, d.y, q.y, p.y, l.y, b) +
         q6_row(s.z, d.z, q.z, p.z, l.z, b) +
         q6_row(s.w, d.w, q.w, p.w, l.w, b);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
q6_filter_sum_kernel(const int* __restrict__ ship,
                     const int* __restrict__ disc,
                     const int* __restrict__ qty,
                     const int* __restrict__ price,
                     const int* __restrict__ live, long long n, Q6Bounds b,
                     int vectorized, unsigned long long* __restrict__ out) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long acc = 0;
  long long tail = 0;
  if (vectorized) {
    const long long nvec = n >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(ship);
    const int4* d4 = reinterpret_cast<const int4*>(disc);
    const int4* q4 = reinterpret_cast<const int4*>(qty);
    const int4* p4 = reinterpret_cast<const int4*>(price);
    const int4* l4 = reinterpret_cast<const int4*>(live);
    for (long long v = tid; v < nvec; v += stride) {
      acc += q6_row4(__ldg(s4 + v), __ldg(d4 + v), __ldg(q4 + v),
                     __ldg(p4 + v), __ldg(l4 + v), b);
    }
    tail = nvec << 2;
  }
  for (long long i = tail + tid; i < n; i += stride) {
    acc += q6_row(__ldg(ship + i), __ldg(disc + i), __ldg(qty + i),
                  __ldg(price + i), __ldg(live + i), b);
  }

  __shared__ long long warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < kWarps ? warp_sums[lane] : 0LL);
    if (lane == 0) {
      // two's-complement addition: the unsigned atomic sums signed values
      atomicAdd(out, static_cast<unsigned long long>(acc));
    }
  }
}

}  // namespace

extern "C" int q6_filter_sum_launch(const void* ship, const void* disc,
                                    const void* qty, const void* price,
                                    const void* live, long long n,
                                    int ship_lo, int ship_hi, int disc_lo,
                                    int disc_hi, int qty_hi, void* out,
                                    void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr_bits =
      reinterpret_cast<uintptr_t>(ship) | reinterpret_cast<uintptr_t>(disc) |
      reinterpret_cast<uintptr_t>(qty) | reinterpret_cast<uintptr_t>(price) |
      reinterpret_cast<uintptr_t>(live);
  const int vectorized = (addr_bits & 15u) == 0 ? 1 : 0;
  const long long items = vectorized ? (n >> 2) + (n & 3) : n;

  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, q6_filter_sum_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);

  long long blocks = (items + kThreads - 1) / kThreads;
  const long long max_blocks =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;

  const Q6Bounds b{ship_lo, ship_hi, disc_lo, disc_hi, qty_hi};
  q6_filter_sum_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ship), static_cast<const int*>(disc),
      static_cast<const int*>(qty), static_cast<const int*>(price),
      static_cast<const int*>(live), n, b, vectorized,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
