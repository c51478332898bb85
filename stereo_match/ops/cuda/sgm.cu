// Semi-global matching path aggregation for NVIDIA Hopper (sm_90a), called
// from JAX through the XLA FFI (see ops/sgm_cuda.py for the Python side).
//
// Volume layout is (H, W, D) with D innermost, so every step of every path
// reads one contiguous run of D costs. One warp owns one scan line (a row,
// a column, a diagonal or an anti-diagonal) and walks it with the path
// carry in registers: lane l holds disparities [l*DPT, l*DPT + DPT), so the
// d-1 / d+1 neighbours cross lanes by one shuffle each and min_k is a warp
// reduction (Hernandez-Juarez et al. 2016; libSGM). The warp walks its line
// forward and then backward, so the two opposite directions of a line family
// share one launch and one owner per pixel: launches need no atomics and the
// running total is summed in the order of ops/sgm.PATH_DIRECTIONS_8, which
// makes the f32 result bit-equal to ops/sgm.sgm_aggregate for any cost.
//
// Recurrence (identical operation order to ops/sgm.scan_direction):
//   m = min(min(L[d], min_k L[k] + P2), min(L[d-1], L[d+1]) + P1)
//   L'[d] = (C[d] + m) - min_k L[k]
//
// Direction indices follow PATH_DIRECTIONS_8: 0 E, 1 W, 2 S, 3 N, 4 SE, 5 NW,
// 6 SW, 7 NE. Family f runs direction 2f forward and 2f+1 backward.
// carry_in / carry_out are (8, W, D): for S/SE/SW the path values of the row
// above the volume (in) and of its last row (out); for N/NW/NE the row below
// (in) and the first row (out). They chain row tiles exactly.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDisparities = 16 * kWarp;

struct Line {
  int y, x, len;
};

__device__ __forceinline__ Line line_start(int family, int k, int H, int W) {
  if (family == 0) return {k, 0, W};
  if (family == 1) return {0, k, H};
  if (family == 2) {  // x - y = k - (H - 1), walking (+1, +1)
    int c = k - (H - 1);
    int y = c < 0 ? -c : 0;
    int x = y + c;
    return {y, x, min(H - y, W - x)};
  }
  // x + y = k, walking (+1, -1)
  int y = k > W - 1 ? k - (W - 1) : 0;
  int x = k - y;
  return {y, x, min(H - y, x + 1)};
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// One direction along one line. `acc` (may alias `total`) is added to the
// path values; nullptr means the total starts at this direction.
template <int DPT, int K>
__device__ __forceinline__ void run_path(
    const float* __restrict__ cost, const float* acc, float* total,
    long long start, long long step, int len, int lane, int D, float p1,
    float p2, const float* __restrict__ init, float* __restrict__ fin) {
  const int d0 = lane * DPT;
  float carry[DPT];
  float lmin = INFINITY;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const bool ok = d0 + j < D;
    carry[j] = ok ? (init ? init[d0 + j] : 0.0f) : INFINITY;
    lmin = fminf(lmin, carry[j]);
  }
  float prev_min = warp_min(lmin);

  float cbuf[K][DPT];
  float tbuf[K][DPT];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < len) {
      const long long off = start + (long long)s * step + d0;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const bool ok = d0 + j < D;
        cbuf[s][j] = ok ? cost[off + j] : 0.0f;
        tbuf[s][j] = (ok && acc) ? acc[off + j] : 0.0f;
      }
    }
  }

  for (int i0 = 0; i0 < len; i0 += K) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int i = i0 + s;
      if (i >= len) break;
      const long long off = start + (long long)i * step + d0;
      float c[DPT], t[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        c[j] = cbuf[s][j];
        t[j] = tbuf[s][j];
      }
      const int nxt = i + K;
      if (nxt < len) {  // refill this slot K steps ahead
        const long long noff = start + (long long)nxt * step + d0;
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          const bool ok = d0 + j < D;
          cbuf[s][j] = ok ? cost[noff + j] : 0.0f;
          tbuf[s][j] = (ok && acc) ? acc[noff + j] : 0.0f;
        }
      }
      float up_edge = __shfl_up_sync(kFull, carry[DPT - 1], 1);
      float dn_edge = __shfl_down_sync(kFull, carry[0], 1);
      if (lane == 0) up_edge = INFINITY;
      if (lane == kWarp - 1) dn_edge = INFINITY;
      const float pm_p2 = prev_min + p2;
      float L[DPT];
      lmin = INFINITY;
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float dm1 = j == 0 ? up_edge : carry[j - 1];
        const float dp1 = j == DPT - 1 ? dn_edge : carry[j + 1];
        const float m = fminf(fminf(carry[j], pm_p2), fminf(dm1, dp1) + p1);
        const float v = (c[j] + m) - prev_min;
        L[j] = d0 + j < D ? v : INFINITY;
        lmin = fminf(lmin, L[j]);
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        carry[j] = L[j];
        if (d0 + j < D) total[off + j] = acc ? t[j] + L[j] : L[j];
      }
      prev_min = warp_min(lmin);
    }
  }
  if (fin) {
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      if (d0 + j < D) fin[d0 + j] = carry[j];
  }
}

template <int DPT>
__global__ void __launch_bounds__(kWarp* kWarpsPerBlock)
    sgm_family_kernel(const float* __restrict__ cost, const float* acc,
                      float* total, const float* __restrict__ carry_in,
                      float* __restrict__ carry_out, int H, int W, int D,
                      float p1, float p2, int family, int do_fwd, int do_rev) {
  constexpr int K = DPT <= 4 ? 8 : (DPT <= 8 ? 4 : 2);
  const int line = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int n_lines = family == 0 ? H : (family == 1 ? W : H + W - 1);
  if (line >= n_lines) return;  // uniform across the warp
  const Line ln = line_start(family, line, H, W);
  const int dy = family == 0 ? 0 : 1;
  const int dx = family == 1 ? 0 : (family == 3 ? -1 : 1);
  const long long step = ((long long)dy * W + dx) * D;
  const long long first = ((long long)ln.y * W + ln.x) * D;
  const long long last = first + (long long)(ln.len - 1) * step;
  const int y_end = ln.y + (ln.len - 1) * dy;
  const int x_end = ln.x + (ln.len - 1) * dx;
  const bool rows = family != 0;  // only row-crossing paths chain carries

  if (do_fwd) {
    const int dir = 2 * family;
    const float* init = nullptr;
    float* fin = nullptr;
    if (rows && ln.y == 0) {
      const int px = ln.x - dx;
      if (px >= 0 && px < W) init = carry_in + ((long long)dir * W + px) * D;
    }
    if (rows && y_end == H - 1)
      fin = carry_out + ((long long)dir * W + x_end) * D;
    run_path<DPT, K>(cost, acc, total, first, step, ln.len, lane, D, p1, p2,
                     init, fin);
  }
  if (do_rev) {
    const int dir = 2 * family + 1;
    const float* init = nullptr;
    float* fin = nullptr;
    if (rows && y_end == H - 1) {
      const int px = x_end + dx;
      if (px >= 0 && px < W) init = carry_in + ((long long)dir * W + px) * D;
    }
    if (rows && ln.y == 0) fin = carry_out + ((long long)dir * W + ln.x) * D;
    run_path<DPT, K>(cost, do_fwd ? total : acc, total, last, -step, ln.len,
                     lane, D, p1, p2, init, fin);
  }
}

template <int DPT>
void launch(cudaStream_t stream, const float* cost, const float* acc,
            float* total, const float* carry_in, float* carry_out, int H, int W,
            int D, float p1, float p2, int family, bool fwd, bool rev) {
  const int n_lines = family == 0 ? H : (family == 1 ? W : H + W - 1);
  const int blocks = (n_lines + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgm_family_kernel<DPT><<<blocks, kWarp * kWarpsPerBlock, 0, stream>>>(
      cost, acc, total, carry_in, carry_out, H, W, D, p1, p2, family, fwd,
      rev);
}

using LaunchFn = void (*)(cudaStream_t, const float*, const float*, float*,
                          const float*, float*, int, int, int, float, float,
                          int, bool, bool);

LaunchFn pick(int D) {
  const int dpt = (D + kWarp - 1) / kWarp;
  if (dpt <= 1) return launch<1>;
  if (dpt <= 2) return launch<2>;
  if (dpt <= 3) return launch<3>;
  if (dpt <= 4) return launch<4>;
  if (dpt <= 5) return launch<5>;
  if (dpt <= 6) return launch<6>;
  if (dpt <= 7) return launch<7>;
  if (dpt <= 8) return launch<8>;
  if (dpt <= 12) return launch<12>;
  return launch<16>;
}

ffi::Error SgmAggregateImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> cost,
                            ffi::Buffer<ffi::F32> total_in,
                            ffi::Buffer<ffi::F32> carry_in,
                            ffi::ResultBuffer<ffi::F32> total,
                            ffi::ResultBuffer<ffi::F32> carry_out, float p1,
                            float p2, int64_t directions) {
  const auto dims = cost.dimensions();
  if (dims.size() != 3)
    return ffi::Error::InvalidArgument("cost must be (H, W, D)");
  const int H = static_cast<int>(dims[0]);
  const int W = static_cast<int>(dims[1]);
  const int D = static_cast<int>(dims[2]);
  if (D < 1 || D > kMaxDisparities)
    return ffi::Error::InvalidArgument(
        "disparity count must be in [1, " + std::to_string(kMaxDisparities) +
        "], got " + std::to_string(D));
  if (carry_in.element_count() != 8ull * W * D)
    return ffi::Error::InvalidArgument("carry_in must be (8, W, D)");
  const bool accumulate = total_in.element_count() == cost.element_count();
  float* out = total->typed_data();
  cudaMemsetAsync(carry_out->typed_data(), 0, carry_out->size_bytes(), stream);
  const float* acc = accumulate ? total_in.typed_data() : nullptr;
  const LaunchFn fn = pick(D);
  bool any = false;
  for (int family = 0; family < 4; ++family) {
    const bool fwd = (directions >> (2 * family)) & 1;
    const bool rev = (directions >> (2 * family + 1)) & 1;
    if (!fwd && !rev) continue;
    fn(stream, cost.typed_data(), acc, out, carry_in.typed_data(),
       carry_out->typed_data(), H, W, D, p1, p2, family, fwd, rev);
    acc = out;
    any = true;
  }
  if (!any) {
    if (accumulate && total_in.typed_data() != out)
      cudaMemcpyAsync(out, total_in.typed_data(), total->size_bytes(),
                      cudaMemcpyDeviceToDevice, stream);
    else if (!accumulate)
      cudaMemsetAsync(out, 0, total->size_bytes(), stream);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("SGM kernel launch failed: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SmtSgmAggregate, SgmAggregateImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // cost
                                  .Arg<ffi::Buffer<ffi::F32>>()  // total_in
                                  .Arg<ffi::Buffer<ffi::F32>>()  // carry_in
                                  .Ret<ffi::Buffer<ffi::F32>>()  // total
                                  .Ret<ffi::Buffer<ffi::F32>>()  // carry_out
                                  .Attr<float>("p1")
                                  .Attr<float>("p2")
                                  .Attr<int64_t>("directions"));
