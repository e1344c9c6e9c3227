// Causal flash attention, forward, for Hopper (sm_90a).
//
// Replaces traceml_tpu/ops/pallas_attention.py:_flash_kernel / _flash_bhsd
// (the Pallas TPU kernel behind ops/attention.py:causal_attention).  It
// computes the same function: softmax(Q K^T / sqrt(D)) V under a causal
// mask, with scores masked at -1e30, an online softmax whose running max,
// sum and accumulator are f32, and the output written once as acc / l in
// the input dtype.  The loop over key tiles stops at the causal diagonal,
// so tiles above it are skipped, not masked.
//
// Design (simple first; wgmma, TMA and pipelining are later work):
//   * one thread block of 256 threads per (batch*head, 64-row query tile);
//     the heaviest query tiles (those nearest the end of the sequence)
//     are launched first so the tail of the grid is short;
//   * Q (pre-scaled by 1/sqrt(D)), a 64-row K tile, a 64-row V tile and
//     the 64x64 probability tile are staged in shared memory as f32;
//   * each thread owns a 4x4 block of the score tile and a 4x(D/16) block
//     of the output accumulator, so both products are register-tiled f32
//     FMAs on the CUDA cores;
//   * q, k, v and o are read and written in the caller's (B, S, H, D)
//     layout through their strides: no transpose copy.
//
// Bound at the main-path shape (B=8, S=1024, H=16, D=64, bf16): the causal
// work is 4*B*H*D*S*(S+1)/2 = 17.2 GFLOP, 17.4 us at 989 TFLOP/s; q, k, v
// and o are 67.1 MB, 20.0 us at 3.35 TB/s.  So the card's bound is memory,
// about 20 us.  This kernel computes in f32 on the CUDA cores (67 TFLOP/s
// peak), not the tensor cores, so it sits far above that bound; moving the
// two products onto the tensor cores is what a faster version must do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // key rows per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;  // element strides of the batch, sequence and head dims
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage rows [row0, row0 + 64) of one (batch, head) into shared memory as
// f32, row stride D + 1 (the pad keeps column reads free of bank conflicts).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          Strides st, int b, int h, int row0,
                                          float mul) {
  const T* base = src + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < kBlockN * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    dst[r * (D + 1) + d] = to_float(base[(long long)(row0 + r) * st.s + d]) * mul;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kPld = kBlockN + 1;
  constexpr int kCols = D / 16;  // output columns owned by one thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockM * kLd;
  float* Vs = Ks + kBlockN * kLd;
  float* Ps = Vs + kBlockN * kLd;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * kBlockM;
  const int tx = threadIdx.x % 16;  // score / output column group
  const int ty = threadIdx.x / 16;  // owns rows 4*ty .. 4*ty+3

  load_tile<T, D>(Qs, q, qs, b, h, q0, scale);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // kBlockM == kBlockN and tiles are aligned, so the diagonal tile is the
  // last one any row of this query tile can see.
  const int n_kv = qt + 1;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlockN;
    __syncthreads();  // the previous tile's K, V and P reads are done
    load_tile<T, D>(Ks, k, ks, b, h, k0, 1.f);
    load_tile<T, D>(Vs, v, vs, b, h, k0, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * kLd + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = Ks[(tx + 16 * jj) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }
    if (j == qt) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (k0 + tx + 16 * jj > q0 + ty * 4 + i) s[i][jj] = kNegInf;
    }

    // Online softmax.  The 16 threads of one row group are 16 consecutive
    // lanes of a warp, so xor-shuffles over offsets 8..1 reduce a row.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        Ps[(ty * 4 + i) * kPld + tx + 16 * jj] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P tile complete

#pragma unroll 4
    for (int kk = 0; kk < kBlockN; ++kk) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * kPld + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[kk * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + ty * 4 + i;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ob[row * os.s + tx + 16 * c] = from_float<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int H, Strides qs, Strides ks, Strides vs, Strides os,
                   float scale, cudaStream_t stream) {
  constexpr int kSmem =
      (kBlockM * (D + 1) + 2 * kBlockN * (D + 1) + kBlockM * (kBlockN + 1)) *
      (int)sizeof(float);
  // above 48 KB of shared memory a block must opt in, on the current device
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, S / kBlockM);
  flash_fwd_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, qs, ks, vs, os, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension must be contiguous.  Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int D, int dtype, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S % kBlockM != 0) return cudaErrorInvalidValue;
  if (S / kBlockM > 65535) return cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, S, H, qs, ks, vs, os, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, S, H, qs, ks, vs, os, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, qs, ks, vs, os, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, qs, ks, vs, os, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
