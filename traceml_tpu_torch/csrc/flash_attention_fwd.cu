// Causal flash attention, forward, for Hopper (sm_90a).
//
// Replaces traceml_tpu/ops/pallas_attention.py:_flash_kernel / _flash_bhsd
// (the Pallas TPU kernel behind ops/attention.py:causal_attention).  It
// computes the same function: softmax(Q K^T / sqrt(D)) V under a causal
// mask, with scores masked at -1e30, an online softmax whose running max,
// sum and accumulator are f32, and the output written once as acc / l in
// the input dtype.  The loop over key tiles stops at the causal diagonal,
// so tiles above it are skipped, not masked.  q, k, v and o are read and
// written in the caller's (B, S, H, D) layout through their strides: no
// transpose copy.
//
// Bound at the main-path shape (B=8, S=1024, H=16, D=64, bf16): the causal
// work is 4*B*H*D*S*(S+1)/2 = 17.2 GFLOP, 17.4 us at 989 TFLOP/s; q, k, v
// and o are 67.1 MB, 20.0 us at 3.35 TB/s.  Both limits are close, so the
// kernel has to keep the tensor cores busy and read each byte once.
//
// bfloat16 (the main path): flash_fwd_wgmma_kernel.
//   * One block of three warpgroups per (batch*head, 128-row query tile),
//     the heaviest query tiles (those nearest the end of the sequence)
//     launched first.  Warpgroup 0 is the producer: one thread starts the TMA
//     copies and the group gives up registers (setmaxnreg).  Warpgroups 1
//     and 2 are consumers, each owning 64 query rows.
//   * Q is staged once; 128-row K and V tiles stream through a 2-stage
//     ring in shared memory, filled by TMA from 4-D tensor maps over
//     (B, S, H, D) with the 128-byte swizzle, with full / empty mbarriers.
//     The producer keeps the next tile in flight while the consumers work.
//   * S = Q K^T is wgmma m64n128k16 (at D=128 two m64n64k16 halves) with
//     both operands in shared memory; O += P V is wgmma m64nDk16 with P in
//     registers: the f32 score fragment is rounded to bf16 in place (its
//     layout packs pair by pair into the A-operand layout), and V is read
//     as stored (MN-major, the transpose-B flag).  The softmax stays in
//     registers.
//   * The diagonal tile is processed first and is the only one masked; a
//     64-key half of it above all of a warpgroup's rows is skipped.
//     Rows past S (a ragged last tile, S = 64 * odd) are read as zeros by
//     TMA, are masked like any key above the diagonal, and are not stored.
// float32: flash_fwd_simt_kernel, f32 FMAs on the CUDA cores, 64-row tiles.
//   It is off the main path and holds the f32 result to 1e-4, which the
//   tensor cores' TF32 could not.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // element strides of the batch, sequence and head dims
};

// ---- bfloat16: wgmma, TMA, mbarrier pipeline -----------------------------

constexpr int kBlockM = 128;   // query rows per block: two consumers of 64
constexpr int kBlockN = 128;   // key rows per tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kBoxCols = 64;   // bf16 columns per TMA box: one 128-byte swizzle row
constexpr int kRowBytes = 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 * 40 + 256 * 232 <= 65536

template <int D>
struct Layout {  // byte offsets into the 1024-aligned dynamic shared memory
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kQBox = kBlockM * kRowBytes;
  static constexpr int kKVBox = kBlockN * kRowBytes;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;  // q_full, k_full[2], v_full[2], empty[2]
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int H, int S, Strides os,
                       float scale_log2) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle needs 1024-byte tiles
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full = q_full + 8;                // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;      // + 8 * stage
  const uint32_t empty = v_full + 8 * kStages;       // + 8 * stage

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = qt * kBlockM;
  const int n_kv = qt + 1;  // key tiles 0..qt; tile qt holds the diagonal
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::prefetch_tensor_map(&tm_q);
    hopper::prefetch_tensor_map(&tm_k);
    hopper::prefetch_tensor_map(&tm_v);
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(k_full + 8 * st, 1);
      hopper::mbar_init(v_full + 8 * st, 1);
      hopper::mbar_init(empty + 8 * st, 2 * 128);  // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // One if / else over the whole kernel, never rejoined: setmaxnreg needs
  // each warpgroup's path to be known from its start.
  if (warpgroup == 0) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, L::kQBytes);
      for (int bx = 0; bx < L::kBoxes; ++bx)
        hopper::tma_load_4d(base + L::kQ + bx * L::kQBox, &tm_q, q_full, bx * kBoxCols, h, q0, b);
      // key tiles from the diagonal down, the order the consumers take them
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % kStages;
        const int k0 = (n_kv - 1 - it) * kBlockN;
        if (it >= kStages) hopper::mbar_wait(empty + 8 * st, ((it / kStages) - 1) & 1);
        const uint32_t k_s = base + L::kK + st * L::kKVBytes;
        const uint32_t v_s = base + L::kV + st * L::kKVBytes;
        hopper::mbar_arrive_expect_tx(k_full + 8 * st, L::kKVBytes);
        for (int bx = 0; bx < L::kBoxes; ++bx)
          hopper::tma_load_4d(k_s + bx * L::kKVBox, &tm_k, k_full + 8 * st, bx * kBoxCols, h, k0, b);
        hopper::mbar_arrive_expect_tx(v_full + 8 * st, L::kKVBytes);
        for (int bx = 0; bx < L::kBoxes; ++bx)
          hopper::tma_load_4d(v_s + bx * L::kKVBox, &tm_v, v_full + 8 * st, bx * kBoxCols, h, k0, b);
      }
    }
  } else {
    hopper::setmaxnreg_inc<kConsumerRegs>();
    constexpr int kAcc = D / 2;  // f32 accumulator registers of m64nD per thread
    // Keys per S = Q K^T product: the whole tile at D=64; at D=128 two
    // halves of 64, so that S, P and O fit in 168 registers, the launch
    // bound's share.  (ptxas allocated these warpgroups within 168 even
    // after the setmaxnreg raise: with 128-key products at D=128 it
    // spilled P and serialized the wgmmas.)
    constexpr int kSubN = D == 64 ? 128 : 64;
    constexpr int kSubs = kBlockN / kSubN;
    const int c = warpgroup - 1;  // query rows 64c .. 64c + 63 of the tile
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int g = lane / 4;  // fragment row within an 8-row group
    const int t = lane % 4;  // fragment column pair
    // This thread's two rows within the tile are row0 and row0 + 8; in the
    // f32 fragments, register 4i + 2r + e sits at row row0 + 8r and
    // column 8i + 2t + e.
    const int row0 = 64 * c + 16 * (tid / 32) + g;
    const uint32_t q_s = base + L::kQ + 64 * c * kRowBytes;

    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of each row's sum

    hopper::mbar_wait(q_full, 0);
    for (int it = 0; it < n_kv; ++it) {
      const int st = it % kStages;
      const uint32_t phase = (it / kStages) & 1;
      const uint32_t k_s = base + L::kK + st * L::kKVBytes;
      const uint32_t v_s = base + L::kV + st * L::kKVBytes;

      hopper::mbar_wait(k_full + 8 * st, phase);
#pragma unroll
      for (int sub = 0; sub < kSubs; ++sub) {
        const int n0 = sub * kSubN;  // first key of this sub-tile within the tile
        // On the diagonal tile, a sub-tile whose keys all lie above this
        // warpgroup's rows adds nothing.
        if (it == 0 && n0 >= 64 * (c + 1)) continue;

        float s[kSubN / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk / 4) * L::kQBox + (kk % 4) * 32;  // kQBox == kKVBox
          const uint64_t dq = hopper::desc_sw128(q_s + off, 16, 1024);
          const uint64_t dk = hopper::desc_sw128(k_s + off + n0 * kRowBytes, 16, 1024);
          if constexpr (kSubN == 128)
            hopper::wgmma_m64n128k16_ss(s, dq, dk, kk > 0);
          else
            hopper::wgmma_m64n64k16_ss(s, dq, dk, kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);

        if (it == 0) {  // the diagonal tile: key column > query row is masked
#pragma unroll
          for (int i = 0; i < kSubN / 8; ++i)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (n0 + 8 * i + 2 * t + e > row0 + 8 * r) s[4 * i + 2 * r + e] = kNegInf;
        }

        // Online softmax.  A row's scores sit in one quad of lanes, so two
        // xor-shuffles reduce it.  exp(x / sqrt(D)) is
        // exp2(x * log2(e) / sqrt(D)), one multiply folded into the FMA.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m[r];
#pragma unroll
          for (int i = 0; i < kSubN / 8; ++i)
            mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float alpha = exp2f((m[r] - mx) * scale_log2);
          const float mx_scaled = mx * scale_log2;
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < kSubN / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p = exp2f(fmaf(s[4 * i + 2 * r + e], scale_log2, -mx_scaled));
              s[4 * i + 2 * r + e] = p;
              sum += p;
            }
          l[r] = l[r] * alpha + sum;
          m[r] = mx;
#pragma unroll
          for (int i = 0; i < D / 8; ++i) {
            acc[4 * i + 2 * r] *= alpha;
            acc[4 * i + 2 * r + 1] *= alpha;
          }
        }

        // P as the A operand of P V: k-step kk (keys 16kk .. 16kk + 15 of
        // the sub-tile) takes registers 8kk .. 8kk + 7 of the score
        // fragment, two to a register.
        uint32_t pa[kSubN / 4];
#pragma unroll
        for (int kk = 0; kk < kSubN / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[4 * kk + r] = hopper::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

        hopper::mbar_wait(v_full + 8 * st, phase);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSubN / 16; ++kk) {
          // 16 key rows = two 8-row swizzle atoms of 1024 bytes per k-step
          const uint64_t dv =
              hopper::desc_sw128(v_s + (n0 + 16 * kk) * kRowBytes, L::kKVBox, 1024);
          if constexpr (D == 64)
            hopper::wgmma_m64n64k16_rs_tb(acc, pa + 4 * kk, dv);
          else
            hopper::wgmma_m64n128k16_rs_tb(acc, pa + 4 * kk, dv);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
      }
      hopper::mbar_arrive(empty + 8 * st);
    }

    // Epilogue: acc / l in bf16, staged in this warpgroup's own rows of the
    // Q tile (same swizzle, so the 4-byte writes miss each other's banks),
    // then written out as 16-byte pieces along each row.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / l[r];
    }
    hopper::named_barrier_sync(1 + c, 128);  // this warpgroup is done reading Q
    hopper::fence_proxy_async();  // its wgmma reads of Q before these writes
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;  // row % 8 == g
        uint8_t* dst = smem + L::kQ + (i / 8) * L::kQBox + row * kRowBytes +
                       (((i % 8) ^ g) * 16) + t * 4;
        *reinterpret_cast<uint32_t*>(dst) =
            hopper::pack_bf16(acc[4 * i + 2 * r] * l[r], acc[4 * i + 2 * r + 1] * l[r]);
      }
    hopper::named_barrier_sync(1 + c, 128);
    constexpr int kChunks = D / 8;  // 16-byte pieces per row
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
    for (int idx = tid; idx < 64 * kChunks; idx += 128) {
      const int row = 64 * c + idx / kChunks;
      const int ch = idx % kChunks;
      if (q0 + row >= S) break;  // rows past S: idx, and so row, only grow
      const uint8_t* src = smem + L::kQ + (ch / 8) * L::kQBox + row * kRowBytes +
                           (((ch % 8) ^ (row % 8)) * 16);
      *reinterpret_cast<uint4*>(ob + (long long)(q0 + row) * os.s + ch * 8) =
          *reinterpret_cast<const uint4*>(src);
    }
  }
}

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which this library does not link,
// so it is looked up through the runtime once.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over a bf16 (B, S, H, D) tensor, innermost first, whose box is
// 64 columns of one head over kBlockM rows, written with the 128-byte swizzle.
// Rows past S read as zeros.
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int B, int S, int H,
              int D, Strides st) {
  static_assert(kBlockM == kBlockN, "one box shape serves Q, K and V");
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, kBlockM, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once on each
// device; `done` holds one bit per device on which `kernel` has.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int H, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                        cudaStream_t stream) {
  // the epilogue's 16-byte stores
  if (reinterpret_cast<uintptr_t>(o) % 16 || os.b % 8 || os.s % 8 || os.h % 8)
    return cudaErrorInvalidValue;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(encode, &mq, q, B, S, H, D, qs) || !make_map(encode, &mk, k, B, S, H, D, ks) ||
      !make_map(encode, &mv, v, B, S, H, D, vs))
    return cudaErrorInvalidValue;
  constexpr int kSmem = Layout<D>::kBytes;
  static std::atomic<unsigned long long> smem_allowed{0};
  cudaError_t err = allow_smem(flash_fwd_wgmma_kernel<D>, kSmem, smem_allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kBlockM - 1) / kBlockM);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), H, S, os, scale * kLog2e);
  return cudaGetLastError();
}

// ---- float32: the CUDA-core kernel ---------------------------------------

constexpr int kSimtBlock = 64;  // query rows per block and key rows per tile
constexpr int kSimtThreads = 256;

constexpr int simt_smem_bytes(int D) {  // Q, K, V and the probability tile
  return (3 * kSimtBlock * (D + 1) + kSimtBlock * (kSimtBlock + 1)) * (int)sizeof(float);
}

// Stage rows [row0, row0 + 64) of one (batch, head) into shared memory,
// row stride D + 1 (the pad keeps column reads free of bank conflicts).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, Strides st,
                                          int b, int h, int row0, float mul) {
  const float* base = src + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < kSimtBlock * D; idx += kSimtThreads) {
    const int r = idx / D;
    const int d = idx % D;
    dst[r * (D + 1) + d] = base[(long long)(row0 + r) * st.s + d] * mul;
  }
}

// One block of 256 threads per (batch*head, 64-row query tile).  Q
// (pre-scaled by 1/sqrt(D)), a K tile, a V tile and the 64x64 probability
// tile sit in shared memory; each thread owns a 4x4 block of the scores and
// a 4x(D/16) block of the output, both register-tiled f32 FMAs.
template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int H, Strides qs,
                      Strides ks, Strides vs, Strides os, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kPld = kSimtBlock + 1;
  constexpr int kCols = D / 16;  // output columns owned by one thread
  extern __shared__ float fsmem[];
  float* Qs = fsmem;
  float* Ks = Qs + kSimtBlock * kLd;
  float* Vs = Ks + kSimtBlock * kLd;
  float* Ps = Vs + kSimtBlock * kLd;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = qt * kSimtBlock;
  const int tx = threadIdx.x % 16;  // score / output column group
  const int ty = threadIdx.x / 16;  // owns rows 4*ty .. 4*ty+3

  load_tile<D>(Qs, q, qs, b, h, q0, scale);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // Query and key tiles are the same size and aligned, so the diagonal
  // tile is the last one any row of this query tile can see.
  const int n_kv = qt + 1;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kSimtBlock;
    __syncthreads();  // the previous tile's K, V and P reads are done
    load_tile<D>(Ks, k, ks, b, h, k0, 1.f);
    load_tile<D>(Vs, v, vs, b, h, k0, 1.f);
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
    for (int kk = 0; kk < kSimtBlock; ++kk) {
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

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + ty * 4 + i;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c) ob[row * os.s + tx + 16 * c] = acc[i][c] * inv;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                       Strides qs, Strides ks, Strides vs, Strides os, float scale,
                       cudaStream_t stream) {
  constexpr int kSmem = simt_smem_bytes(D);
  static std::atomic<unsigned long long> smem_allowed{0};
  cudaError_t err = allow_smem(flash_fwd_simt_kernel<D>, kSmem, smem_allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, S / kSimtBlock);
  flash_fwd_simt_kernel<D><<<grid, kSimtThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, qs, ks, vs, os, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension must be contiguous, and S a multiple of 64.  Returns the
// launch's cudaError_t (a tensor map that cuTensorMapEncodeTiled refuses
// is cudaErrorInvalidValue).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int S, int H,
    int D, int dtype, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, float scale,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S % kSimtBlock != 0) return cudaErrorInvalidValue;
  if (S / kSimtBlock > 65535) return cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, o, B, S, H, qs, ks, vs, os, scale, st);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, o, B, S, H, qs, ks, vs, os, scale, st);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, o, B, S, H, qs, ks, vs, os, scale, st);
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, o, B, S, H, qs, ks, vs, os, scale, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the kernel for (dtype, D), in
// bytes, or -1 for a pair the kernel does not take.
extern "C" int flash_attention_smem_bytes(int dtype, int D) {
  if (dtype == 0 && (D == 64 || D == 128)) return simt_smem_bytes(D);
  if (dtype == 1 && D == 64) return Layout<64>::kBytes;
  if (dtype == 1 && D == 128) return Layout<128>::kBytes;
  return -1;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
