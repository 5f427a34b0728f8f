// K1 and K2: fused scans with one packed survivor per bin, for Hopper
// (sm_90a).
//
// K1 replaces coltt_tpu/ops/scan_pallas.py::_kernel (launched by
// _binmax_scan). For every query q and every bin b of a row chunk
// (chunk = nsl slices of 128 rows; bin b holds rows s*128 + b, s < nsl):
//
//   dot  = q . row                       (s8 x s8 -> s32 for int8 codes,
//                                         else operands in f32, rounded to
//                                         bf16 when round_bf16 is set,
//                                         summed in f32)
//   val  = dot * rowmul[row] + rowadd[row]      (two roundings, no FMA)
//   key  = (bits(val) & -nsl) | s
//   out[q, chunk*128 + b] = max over s of key   (int32; ties -> higher s)
//
// rowadd carries the tombstone penalty and a positivity bias, so the f32
// bits of every valid val order like the value; see fused_scan.py.
//
// K2 replaces coltt_tpu/ops/scan_pallas.py::_int_kernel (launched by
// _binmax_scan_i8): unit-norm rows under one global int8 scale, so the raw
// s8 x s8 -> s32 dot is the ranking key and the epilogue is all-integer:
//
//   key  = (dot << log2(nsl)) | s        (shifted as uint32: no UB on a
//                                         negative dot; |dot| <= 127^2 * D
//                                         and D <= 2048 keep it under 2^30)
//   out[q, chunk*128 + b] = max over s of key
//
// What bounds them on the H100: at the serving shape (Q=2048, N=1M,
// D=768) the product is 3.3e12 s8 operations, 1.67 ms at the int8
// tensor-core peak, while the codes, row factors and [Q, N/32] keys are
// 1.1 GB, 0.32 ms of memory bandwidth: operations bound them. At Q=8
// the codes' bytes do.
//
// Int8 codes (K1) and K2 share one tensor-core loop, binmax_scan_s8_kernel:
// a block owns a tile of 32, 64 or 128 queries (the least that covers Q,
// picked by the wrapper) x the 128 bins of one chunk. A producer warp
// streams the chunk's code tiles (128 rows x 128 bytes of D) through a
// 4-stage TMA ring guarded by mbarriers; two consumer warpgroups each run
// wgmma m64nNk32 s8 x s8 -> s32 on 64 code rows of every tile (code rows
// are wgmma's M side, queries its N side, both K-major as stored), so the
// running max over slices stays in the same accumulator registers from
// slice to slice and only [Q, N/32] keys reach device memory. Where the
// query tile fits in shared memory beside the ring (128 queries up to
// D=1152, 64 up to 2560, 32 up to 5120), TMA loads it once and it stays
// resident; past that, each ring stage carries the query tile's matching
// 128-byte k-block beside the code tile, so every D % 128 == 0 runs this
// loop. The keys leave through shared memory as 16-byte stores of each
// query's 128 bins. Query tiles are the grid's fastest axis: the blocks
// that share a chunk run together and read its codes from L2, so the
// codes come from device memory about once per call.
//
// Float codes (K1 on f8, bf16 and f32) keep a CUDA-core loop: a block owns
// 64 queries x 128 bins and stages 32 words of D at a time through shared
// memory into a 4 x 8 register tile per thread (fmaf); bf16 wgmma is the
// next redesign.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kLanes = 128;  // bins per chunk = rows per slice
constexpr int kBadArgument = -1;
constexpr int kTensorMapFailed = -2;

// K1's epilogue: the per-row affine, rounded twice, then the bit pack.
struct AffineKey {
  const float* __restrict__ rowmul;
  const float* __restrict__ rowadd;
  int32_t mask;  // -nsl: clears the low log2(nsl) bits
  struct Row {
    float m, c;
  };
  __device__ __forceinline__ Row row(int r) const { return {rowmul[r], rowadd[r]}; }
  template <typename Acc>
  __device__ __forceinline__ int32_t key(Acc acc, Row rw, int s) const {
    float dot;
    if constexpr (std::is_same<Acc, int>::value) {
      dot = __int2float_rn(acc);  // exact for D <= 1040; else rounded as the plain version
    } else {
      dot = acc;
    }
    const float val = __fadd_rn(__fmul_rn(dot, rw.m), rw.c);
    return (__float_as_int(val) & mask) | s;
  }
};

// K2's epilogue: the dot shifted over the slice bits, as uint32.
struct ShiftKey {
  int sh;  // log2(nsl)
  struct Row {};
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ int32_t key(int acc, Row, int s) const {
    return static_cast<int32_t>((static_cast<uint32_t>(acc) << sh) | static_cast<uint32_t>(s));
  }
};

// -- int8 codes: wgmma fed by TMA (K1 on int8 codes, and K2) ---------------------

constexpr int kStages = 4;                     // code tiles in flight
constexpr int kTileBytes = kLanes * 128;       // one tile: 128 rows x 128 bytes of D
constexpr int kStagingStride = kLanes + 4;     // int32 words per query row of the key staging
constexpr int kS8Threads = 384;                // producer warpgroup + two consumer warpgroups

// Shared memory of the s8 kernel, the one place its layout is known:
// 1024-byte alignment slack, the resident query tile (none when queries
// stream), the ring (which becomes the key staging area after the last
// slice), the mbarriers. launch_s8_tile streams the queries when the
// resident layout exceeds the card's opt-in limit.
__host__ __device__ constexpr int stage_bytes(int qtile, bool stream) {
  return kTileBytes + (stream ? qtile * 128 : 0);
}

__host__ __device__ constexpr int ring_bytes(int qtile, bool stream) {
  return kStages * stage_bytes(qtile, stream) > qtile * kStagingStride * 4
             ? kStages * stage_bytes(qtile, stream)
             : qtile * kStagingStride * 4;
}

__host__ __device__ constexpr int s8_smem_bytes(int qtile, int d, bool stream) {
  return 1024 + (stream ? 0 : qtile * d) + ring_bytes(qtile, stream) + (2 * kStages + 1) * 8;
}

// kStream: the query k-blocks ride in the ring beside the code tiles
// instead of staying resident.
template <int BN, bool kStream, typename Epilogue>
__global__ void __launch_bounds__(kS8Threads, 1)
binmax_scan_s8_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap cmap, const Epilogue epilogue,
                      int32_t* __restrict__ out, int qp, int n, int d, int nsl) {
  constexpr int kAcc = BN / 2;  // s32 accumulators a thread: 64 rows x BN over 128 threads
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // 128-byte swizzle atoms must start on 1024-byte boundaries
  uint8_t* const sq = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  // [kStages][128 code rows x 128 bytes, then BN query rows x 128 bytes
  // when kStream]
  uint8_t* const ring = sq + (kStream ? 0 : BN * d);
  constexpr int kStage = stage_bytes(BN, kStream);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + ring_bytes(BN, kStream));
  uint64_t* const empty = full + kStages;
  uint64_t* const qbar = empty + kStages;

  const int kblocks = d / 128;
  const int q0 = blockIdx.x * BN;
  const int chunk = blockIdx.y;
  const int row0 = chunk * nsl * kLanes;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hopper::mbar_init(&full[i], 1);   // the producer's expect_tx arrival
      hopper::mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full; the rest of the warpgroup
    // hands its registers to the consumers
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      // the query tile, as d/128 boxes of [BN rows][128 bytes]; rows past
      // qp read as zeros
      if (!kStream) {
        hopper::mbar_expect_tx(qbar, BN * d);
        for (int kb = 0; kb < kblocks; ++kb) {
          hopper::tma_load_2d(sq + kb * BN * 128, &qmap, qbar, kb * 128, q0);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < nsl; ++s) {
        for (int kb = 0; kb < kblocks; ++kb) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&full[stage], kStage);
          hopper::tma_load_2d(ring + stage * kStage, &cmap, &full[stage], kb * 128,
                              row0 + s * kLanes);
          if (kStream) {
            hopper::tma_load_2d(ring + stage * kStage + kTileBytes, &qmap, &full[stage],
                                kb * 128, q0);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup h owns rows [64h, 64h + 64) of every slice
    hopper::setmaxnreg_inc<232>();
    const int h = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_lo = h * 64 + (t / 32) * 16 + lane / 4;  // rows r_lo and r_lo + 8
    const int c_lo = (lane % 4) * 2;                     // queries c_lo + {0, 1} + 8j

    uint32_t acc[kAcc];
    int32_t best[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      acc[i] = 0u;
      best[i] = 0;
    }
    if (!kStream) hopper::mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int s = 0; s < nsl; ++s) {
      const auto rw0 = epilogue.row(row0 + s * kLanes + r_lo);
      const auto rw1 = epilogue.row(row0 + s * kLanes + r_lo + 8);
      int prev = 0;
      for (int kb = 0; kb < kblocks; ++kb) {
        hopper::mbar_wait(&full[stage], phase);
        const uint8_t* a = ring + stage * kStage + h * 64 * 128;
        const uint8_t* b = kStream ? ring + stage * kStage + kTileBytes : sq + kb * BN * 128;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          hopper::Wgmma<BN>::run(acc, hopper::desc_sw128(a + 32 * k),
                                 hopper::desc_sw128(b + 32 * k), (kb | k) != 0);
        }
        hopper::wgmma_commit();
        hopper::fence_regs(acc);
        if (kb > 0) {
          // the previous tile's products are done: hand its stage back
          hopper::wgmma_wait<1>();
          hopper::fence_regs(acc);
          if (lane == 0) hopper::mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int32_t key = epilogue.key(static_cast<int>(acc[i]), (i & 2) ? rw1 : rw0, s);
        best[i] = (s == 0) ? key : max(best[i], key);
      }
    }

    // Both consumer warpgroups are done with the ring, whose loads have all
    // landed: it becomes the staging area [BN queries][kStagingStride].
    hopper::named_barrier(1, 256);
    int32_t* const stg = reinterpret_cast<int32_t*>(ring);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int q = (i / 4) * 8 + c_lo + (i & 1);
      stg[q * kStagingStride + r_lo + ((i & 2) ? 8 : 0)] = best[i];
    }
    hopper::named_barrier(1, 256);
    const int nbins = (n / (nsl * kLanes)) * kLanes;
    for (int v = threadIdx.x - 128; v < BN * (kLanes / 4); v += 256) {
      const int q = v / (kLanes / 4);
      const int c = v % (kLanes / 4);
      if (q0 + q < qp) {
        *reinterpret_cast<int4*>(out + static_cast<size_t>(q0 + q) * nbins + chunk * kLanes +
                                 c * 4) =
            *reinterpret_cast<const int4*>(stg + q * kStagingStride + c * 4);
      }
    }
  }
}

template <int BN, bool kStream, typename Epilogue>
int launch_s8_layout(const CUtensorMap& qmap, const CUtensorMap& cmap, const Epilogue& epilogue,
                     int32_t* out, int qp, int n, int d, int nsl, cudaStream_t stream) {
  const int smem = s8_smem_bytes(BN, d, kStream);
  const auto kernel = binmax_scan_s8_kernel<BN, kStream, Epilogue>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((qp + BN - 1) / BN, n / (nsl * kLanes));
  kernel<<<grid, kS8Threads, smem, stream>>>(qmap, cmap, epilogue, out, qp, n, d, nsl);
  return static_cast<int>(cudaGetLastError());
}

// The resident query tile where it fits in the card's opt-in shared
// memory, else the streamed one (at most 132 KB at 128 queries).
template <int BN, typename Epilogue>
int launch_s8_tile(const void* q, const void* c, const Epilogue& epilogue, int32_t* out, int qp,
                   int n, int d, int nsl, cudaStream_t stream) {
  CUtensorMap qmap, cmap;
  if (!hopper::tile_map_u8(&qmap, q, qp, d, BN) || !hopper::tile_map_u8(&cmap, c, n, d, kLanes)) {
    return kTensorMapFailed;
  }
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s8_smem_bytes(BN, d, false) <= limit) {
    return launch_s8_layout<BN, false>(qmap, cmap, epilogue, out, qp, n, d, nsl, stream);
  }
  return launch_s8_layout<BN, true>(qmap, cmap, epilogue, out, qp, n, d, nsl, stream);
}

template <typename Epilogue>
int launch_s8(int qtile, const void* q, const void* c, const Epilogue& epilogue, int32_t* out,
              int qp, int n, int d, int nsl, cudaStream_t stream) {
  if (d <= 0 || d % 128 != 0) return kBadArgument;
  switch (qtile) {
    case 32:
      return launch_s8_tile<32>(q, c, epilogue, out, qp, n, d, nsl, stream);
    case 64:
      return launch_s8_tile<64>(q, c, epilogue, out, qp, n, d, nsl, stream);
    case 128:
      return launch_s8_tile<128>(q, c, epilogue, out, qp, n, d, nsl, stream);
    default:
      return kBadArgument;
  }
}

// -- float codes: the CUDA-core loop (K1 on f8, bf16 and f32 codes) ---------------

constexpr int kQTile = 64;           // queries per block
constexpr int kWords = 32;           // 32-bit shared words per row and k-step
constexpr int kStride = kWords + 1;  // padded shared row: conflict-free reads
constexpr int kThreads = 256;        // 16 (lanes) x 16 (queries)
constexpr int kTM = 4;               // queries per thread
constexpr int kTN = 8;               // lanes per thread: tx + 16 * j

__device__ __forceinline__ uint32_t operand_bits(float x, bool round_bf16) {
  if (round_bf16) x = __bfloat162float(__float2bfloat16_rn(x));
  return __float_as_uint(x);
}

// One 16-byte load -> 32-bit shared words, one f32 operand per word.
template <typename T>
struct Unpack;

template <>
struct Unpack<__nv_fp8_e4m3> {
  static constexpr int kWordsPer16 = 16;
  __device__ __forceinline__ static void run(const uint4& v, uint32_t* w, bool) {
    const uint32_t p[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      __nv_fp8_e4m3 e;
      e.__x = static_cast<__nv_fp8_storage_t>((p[i / 4] >> (8 * (i % 4))) & 0xffu);
      // e4m3 values are exact in bf16 and in f32: no rounding to apply
      w[i] = __float_as_uint(static_cast<float>(e));
    }
  }
};

template <>
struct Unpack<__nv_bfloat16> {
  static constexpr int kWordsPer16 = 8;
  __device__ __forceinline__ static void run(const uint4& v, uint32_t* w, bool) {
    const uint32_t p[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = ((p[i / 2] >> (16 * (i % 2))) & 0xffffu) << 16;  // bf16 -> f32 bits
    }
  }
};

template <>
struct Unpack<float> {
  static constexpr int kWordsPer16 = 4;
  __device__ __forceinline__ static void run(const uint4& v, uint32_t* w, bool round_bf16) {
    w[0] = operand_bits(__uint_as_float(v.x), round_bf16);
    w[1] = operand_bits(__uint_as_float(v.y), round_bf16);
    w[2] = operand_bits(__uint_as_float(v.z), round_bf16);
    w[3] = operand_bits(__uint_as_float(v.w), round_bf16);
  }
};

// Elements of D one k-step covers: 32 for float codes.
template <typename T>
__host__ __device__ constexpr int step_elems() {
  return (kWords / Unpack<T>::kWordsPer16) * (16 / static_cast<int>(sizeof(T)));
}

// Stage rows [row0, row0 + rows) x elements [k0, k0 + step) into shared
// memory; rows at or past row_limit read as zeros.
template <typename T>
__device__ __forceinline__ void load_tile(uint32_t* s, const T* __restrict__ g, int rows,
                                          int row0, int row_limit, int d, int k0,
                                          bool round_bf16) {
  constexpr int kW = Unpack<T>::kWordsPer16;
  constexpr int kU = kWords / kW;                   // 16-byte loads per row
  constexpr int kE = 16 / static_cast<int>(sizeof(T));  // elements per load
  for (int i = threadIdx.x; i < rows * kU; i += kThreads) {
    const int r = i / kU;
    const int u = i % kU;
    uint32_t w[kW];
    if (row0 + r < row_limit) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          g + static_cast<size_t>(row0 + r) * d + k0 + u * kE);
      Unpack<T>::run(v, w, round_bf16);
    } else {
#pragma unroll
      for (int j = 0; j < kW; ++j) w[j] = 0u;
    }
#pragma unroll
    for (int j = 0; j < kW; ++j) s[r * kStride + u * kW + j] = w[j];
  }
}

template <typename C>
__global__ void __launch_bounds__(kThreads)
binmax_scan_fma_kernel(const float* __restrict__ queries, const C* __restrict__ codes,
                       const AffineKey epilogue, int32_t* __restrict__ out, int qp, int n, int d,
                       int nsl, bool round_bf16) {
  constexpr int kStep = step_elems<C>();
  static_assert(kStep == step_elems<float>(), "query and code k-steps differ");

  __shared__ uint32_t sq[kQTile * kStride];
  __shared__ uint32_t sc[kLanes * kStride];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kQTile;
  const int chunk = blockIdx.y;
  const int chunk_rows = nsl * kLanes;
  const int nbins = (n / chunk_rows) * kLanes;

  int32_t best[kTM][kTN];
  for (int s = 0; s < nsl; ++s) {
    const int row0 = chunk * chunk_rows + s * kLanes;
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += kStep) {
      load_tile<float>(sq, queries, kQTile, q0, qp, d, k0, round_bf16);
      load_tile<C>(sc, codes, kLanes, row0, n, d, k0, round_bf16);
      __syncthreads();
#pragma unroll 8
      for (int w = 0; w < kWords; ++w) {
        uint32_t a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = sq[(ty * kTM + i) * kStride + w];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = sc[(tx + 16 * j) * kStride + w];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            acc[i][j] = fmaf(__uint_as_float(a[i]), __uint_as_float(b[j]), acc[i][j]);
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const auto rw = epilogue.row(row0 + tx + 16 * j);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int32_t key = epilogue.key(acc[i][j], rw, s);
        best[i][j] = (s == 0) ? key : max(best[i][j], key);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int q = q0 + ty * kTM + i;
    if (q >= qp) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      out[static_cast<size_t>(q) * nbins + chunk * kLanes + tx + 16 * j] = best[i][j];
    }
  }
}

template <typename C>
int launch_fma(const void* q, const void* c, const AffineKey& epilogue, int32_t* out, int qp,
               int n, int d, int nsl, int round_bf16, cudaStream_t stream) {
  if (d % step_elems<C>() != 0) return kBadArgument;
  const dim3 grid((qp + kQTile - 1) / kQTile, n / (nsl * kLanes));
  binmax_scan_fma_kernel<C><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const C*>(c), epilogue, out, qp, n, d, nsl,
      round_bf16 != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Code dtypes, as fused_scan.py numbers them.
enum : int { kCodeInt8 = 0, kCodeFp8 = 1, kCodeBf16 = 2, kCodeFp32 = 3 };

// K1. qtile (32, 64 or 128 queries a block) is read for int8 codes only.
extern "C" int coltt_binmax_scan(int code_dtype, const void* queries, const void* codes,
                                 const float* rowmul, const float* rowadd, int32_t* out,
                                 int qp, int n, int d, int nsl, int round_bf16, int qtile,
                                 void* stream) {
  if (qp <= 0 || n <= 0 || nsl <= 0 || n % (nsl * kLanes) != 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const AffineKey e{rowmul, rowadd, -nsl};
  switch (code_dtype) {
    case kCodeInt8:
      return launch_s8(qtile, queries, codes, e, out, qp, n, d, nsl, s);
    case kCodeFp8:
      return launch_fma<__nv_fp8_e4m3>(queries, codes, e, out, qp, n, d, nsl, round_bf16, s);
    case kCodeBf16:
      return launch_fma<__nv_bfloat16>(queries, codes, e, out, qp, n, d, nsl, round_bf16, s);
    case kCodeFp32:
      return launch_fma<float>(queries, codes, e, out, qp, n, d, nsl, round_bf16, s);
    default:
      return kBadArgument;
  }
}

// K2. d <= 2048 keeps (dot << log2(nsl)) + 2^30 inside int32 (fused_scan.py).
extern "C" int coltt_binmax_scan_i8(const void* queries, const void* codes, int32_t* out,
                                    int qp, int n, int d, int nsl, int qtile, void* stream) {
  if (qp <= 0 || n <= 0 || nsl <= 0 || (nsl & (nsl - 1)) != 0 || n % (nsl * kLanes) != 0 ||
      d > 2048) {
    return kBadArgument;
  }
  int sh = 0;
  while ((1 << sh) < nsl) ++sh;
  return launch_s8(qtile, queries, codes, ShiftKey{sh}, out, qp, n, d, nsl,
                   static_cast<cudaStream_t>(stream));
}

extern "C" const char* coltt_error_string(int code) {
  if (code == kBadArgument) return "coltt_binmax_scan: bad argument";
  if (code == kTensorMapFailed) return "coltt_binmax_scan: cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
