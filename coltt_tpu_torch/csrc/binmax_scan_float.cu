// K1's float-code loops, for Hopper (sm_90a): the function that
// binmax_scan.cu's header states (K1 replaces
// coltt_tpu/ops/scan_pallas.py::_kernel) on f8 (e4m3), bf16 and f32 codes.
//
// bf16 operands (round_bf16: f8 and bf16 codes, and f32 codes searched
// with compute_dtype=bf16): binmax_scan_bf16_kernel. The reference
// multiplies bf16 x bf16 with f32 sums (scan_pallas.py:152-157), which is
// wgmma's bf16 form. What bounds it on the H100 at the serving shape
// (Q=2048, N=1M, D=768): 3.3e12 operations, 3.335 ms at 989 TFLOP/s,
// while the codes (0.8 GB f8, 1.6 GB bf16) take 0.24 / 0.48 ms of memory
// bandwidth; at Q=8 the codes' bytes bound it. Between the two sits L2:
// every query tile of a chunk reads the chunk's codes again, so a block
// keeps as many queries resident as shared memory holds beside the ring
// (96 at D=768, 144 KB), and each code byte read from L2 serves them all.
// The skeleton is the int8 loop's: a producer warp keeps a TMA ring of
// 64-element k-blocks full (128 code rows, plus the query tile's k-block
// where the queries stream), two consumer warpgroups run wgmma m64nNk16
// bf16 x bf16 -> f32 on 64 code rows each, the running max over slices
// stays in registers, and the keys leave through shared memory.
// bf16 codes feed wgmma from shared memory as TMA lays them down (128-byte
// swizzle). f8 and f32 codes are not bf16 in memory: each consumer thread
// reads its own A fragment from the raw tile and widens it in registers
// (e4m3 exactly, f32 rounded to nearest even), and wgmma takes A from
// registers. So that a thread's fragment is one run of bytes per row, the
// wrapper stores the bf16 queries of f8 and f32 codes with each 64-element
// k-block permuted (fused_scan.kernel_queries): logical k = 16j + 8h + 2t
// + e of step j holds element 16t + 4j + 2h + e, the element thread t of
// the fragment layout reads from its run.
//
// Exact f32 operands (round_bf16 unset: NONE stores, and any store
// searched with compute_dtype=f32): binmax_scan_f32_kernel. The
// reference's product is f32 x f32; TF32 or split-bf16 tensor-core forms
// compute another function, so it stays on CUDA cores: 2*Q*N*D = 3.3e12
// operations at Q=2048 take 49.2 ms at 67 TFLOP/s (Q=8: the f32 codes'
// 3.2 GB bound it, 0.96 ms). A register-blocked SIMT product: a block
// owns up to 128 queries x the 128 bins of a chunk, each of 256 threads
// an 8 x 8 tile (2 x 4 to 4 x 8 for a small batch), 64-element k-blocks
// of queries and codes land in padded shared memory by cp.async, double
// buffered, and each thread reads its fragments as 16-byte loads one
// step ahead of its FMAs. The running max keys wait in shared memory, so
// the registers hold the tile and its fragments.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "binmax_common.cuh"
#include "hopper.cuh"

namespace {

// -- bf16 operands: wgmma fed by TMA ----------------------------------------------

constexpr int kKBlock = 64;                 // elements of D a ring stage carries
constexpr int kQueryBox = kKBlock * 2;      // bytes of one query's bf16 k-block
constexpr int kBf16Threads = 384;           // producer warpgroup + two consumer warpgroups
constexpr int kStagingStride = kLanes + 4;  // int32 words per query row of the key staging
constexpr int kRingBudget = 64 * 1024;      // ring bytes beside resident queries (x2 streamed)

// Code operands. kBytes: one stage's 128 rows x 64 elements. kRegsA: the
// consumers widen the raw tile into wgmma's register A fragments.
template <typename C>
struct Codes;

template <>
struct Codes<__nv_bfloat16> {
  static constexpr int kBytes = kLanes * kKBlock * 2;  // one [128][128 B] box, 128-byte swizzle
  static constexpr bool kRegsA = false;
  static bool map(CUtensorMap* m, const void* c, int n, int d) {
    return hopper::tile_map_u8(m, c, n, 2ull * d, kLanes);
  }
  __device__ __forceinline__ static void load(uint8_t* dst, const CUtensorMap* m, uint64_t* bar,
                                              int kb, int row) {
    hopper::tma_load_2d(dst, m, bar, kb * 128, row);
  }
};

template <>
struct Codes<__nv_fp8_e4m3> {
  // one [128][64 B] box, not swizzled: the 16-byte runs that a quarter
  // warp reads lie on distinct banks
  static constexpr int kBytes = kLanes * kKBlock;
  static constexpr bool kRegsA = true;
  static bool map(CUtensorMap* m, const void* c, int n, int d) {
    return hopper::tile_map_u8(m, c, n, d, kLanes, kKBlock, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  __device__ __forceinline__ static void load(uint8_t* dst, const CUtensorMap* m, uint64_t* bar,
                                              int kb, int row) {
    hopper::tma_load_2d(dst, m, bar, kb * kKBlock, row);
  }
  // Rows r and r + 8, elements [16t, 16t + 16): step j's fragment
  __device__ __forceinline__ static void fragments(const uint8_t* tile, int r, int t,
                                                   uint32_t (&f)[4][4]) {
    const uint4 lo = *reinterpret_cast<const uint4*>(tile + r * kKBlock + t * 16);
    const uint4 hi = *reinterpret_cast<const uint4*>(tile + (r + 8) * kKBlock + t * 16);
    const uint32_t a[4] = {lo.x, lo.y, lo.z, lo.w};
    const uint32_t b[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[j][0] = hopper::e4m3x2_to_bf16x2(a[j] & 0xFFFFu);
      f[j][1] = hopper::e4m3x2_to_bf16x2(b[j] & 0xFFFFu);
      f[j][2] = hopper::e4m3x2_to_bf16x2(a[j] >> 16);
      f[j][3] = hopper::e4m3x2_to_bf16x2(b[j] >> 16);
    }
  }
};

template <>
struct Codes<float> {
  // two [128][128 B] boxes of 32 elements, 128-byte swizzle
  static constexpr int kBytes = kLanes * kKBlock * 4;
  static constexpr bool kRegsA = true;
  static bool map(CUtensorMap* m, const void* c, int n, int d) {
    return hopper::tile_map_u8(m, c, n, 4ull * d, kLanes);
  }
  __device__ __forceinline__ static void load(uint8_t* dst, const CUtensorMap* m, uint64_t* bar,
                                              int kb, int row) {
    hopper::tma_load_2d(dst, m, bar, kb * 256, row);
    hopper::tma_load_2d(dst + kBytes / 2, m, bar, kb * 256 + 128, row);
  }
  // Elements [16t + 4u, 16t + 4u + 4) of row r: box t / 2, 16-byte chunk
  // 4 (t % 2) + u, stored at chunk ^ (r % 8)
  __device__ __forceinline__ static float4 run(const uint8_t* tile, int r, int t, int u) {
    const int c = (t & 1) * 4 + u;
    return *reinterpret_cast<const float4*>(tile + (t >> 1) * (kBytes / 2) + r * 128 +
                                            ((c ^ (r & 7)) << 4));
  }
  __device__ __forceinline__ static void fragments(const uint8_t* tile, int r, int t,
                                                   uint32_t (&f)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 x = run(tile, r, t, j);
      const float4 y = run(tile, r + 8, t, j);
      f[j][0] = hopper::f32x2_to_bf16x2(x.x, x.y);
      f[j][1] = hopper::f32x2_to_bf16x2(y.x, y.y);
      f[j][2] = hopper::f32x2_to_bf16x2(x.z, x.w);
      f[j][3] = hopper::f32x2_to_bf16x2(y.z, y.w);
    }
  }
};

// Shared memory of the bf16 kernel, the one place its layout is known
// (fused_scan.bf16_query_tile mirrors it): 1024-byte alignment slack, the
// resident query tile (none when queries stream), the ring (which becomes
// the key staging area after the last slice), the mbarriers.
__host__ __device__ constexpr int bf16_stage_bytes(int code_bytes, int qtile, bool stream) {
  return code_bytes + (stream ? qtile * kQueryBox : 0);
}

// as many stages as the budget holds, from 2 to 8
__host__ __device__ constexpr int bf16_stages(int code_bytes, int qtile, bool stream) {
  const int fit = (stream ? 2 : 1) * kRingBudget / bf16_stage_bytes(code_bytes, qtile, stream);
  return fit < 2 ? 2 : (fit > 8 ? 8 : fit);
}

__host__ __device__ constexpr int bf16_ring_bytes(int code_bytes, int qtile, bool stream) {
  const int ring = bf16_stages(code_bytes, qtile, stream) *
                   bf16_stage_bytes(code_bytes, qtile, stream);
  const int staging = qtile * kStagingStride * 4;
  return ring > staging ? ring : staging;
}

__host__ __device__ constexpr int bf16_smem_bytes(int code_bytes, int qtile, int d, bool stream) {
  return 1024 + (stream ? 0 : qtile * d * 2) + bf16_ring_bytes(code_bytes, qtile, stream) +
         (2 * bf16_stages(code_bytes, qtile, stream) + 1) * 8;
}

template <int BN, bool kStream, typename C>
__global__ void __launch_bounds__(kBf16Threads, 1)
binmax_scan_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap cmap, const AffineKey epilogue,
                        int32_t* __restrict__ out, int qp, int n, int d, int nsl) {
  using Code = Codes<C>;
  constexpr int kAcc = BN / 2;  // f32 accumulators a thread: 64 rows x BN over 128 threads
  constexpr int kStage = bf16_stage_bytes(Code::kBytes, BN, kStream);
  constexpr int kStages = bf16_stages(Code::kBytes, BN, kStream);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // 128-byte swizzle atoms must start on 1024-byte boundaries
  uint8_t* const sq = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  // [kStages][code tile, then BN query rows x 128 bytes when kStream]
  uint8_t* const ring = sq + (kStream ? 0 : BN * d * 2);
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(ring + bf16_ring_bytes(Code::kBytes, BN, kStream));
  uint64_t* const empty = full + kStages;
  uint64_t* const qbar = empty + kStages;

  const int kblocks = d / kKBlock;  // even: D % 128 == 0
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
      // the query tile, as d/64 boxes of [BN rows][128 bytes]; rows past
      // qp read as zeros
      if (!kStream) {
        hopper::mbar_expect_tx(qbar, BN * d * 2);
        for (int kb = 0; kb < kblocks; ++kb) {
          hopper::tma_load_2d(sq + kb * BN * kQueryBox, &qmap, qbar, kb * kQueryBox, q0);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < nsl; ++s) {
        for (int kb = 0; kb < kblocks; ++kb) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&full[stage], kStage);
          Code::load(ring + stage * kStage, &cmap, &full[stage], kb, row0 + s * kLanes);
          if (kStream) {
            hopper::tma_load_2d(ring + stage * kStage + Code::kBytes, &qmap, &full[stage],
                                kb * kQueryBox, q0);
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

    float acc[kAcc];
    int32_t best[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      acc[i] = 0.0f;
      best[i] = 0;
    }
    // A fragments of two k-blocks in flight (register-A codes only)
    uint32_t fa[4][4], fb[4][4];
    if (!kStream) hopper::mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    int prev = 0;

    // k-block kb's four products; f takes its A fragments, g holds those
    // of the group issued before it, which ends here
    auto issue = [&](int kb, uint32_t(&f)[4][4], uint32_t(&g)[4][4]) {
      hopper::mbar_wait(&full[stage], phase);
      const uint8_t* tile = ring + stage * kStage;
      const uint8_t* b = kStream ? tile + Code::kBytes : sq + kb * BN * kQueryBox;
      if constexpr (Code::kRegsA) Code::fragments(tile, r_lo, lane % 4, f);
      hopper::fence_regs(acc);
      if constexpr (Code::kRegsA) hopper::fence_regs(f);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (Code::kRegsA) {
          hopper::WgmmaBf16<BN>::rs(acc, f[k], hopper::desc_sw128(b + 32 * k), (kb | k) != 0);
        } else {
          hopper::WgmmaBf16<BN>::ss(acc, hopper::desc_sw128(tile + h * 64 * 128 + 32 * k),
                                    hopper::desc_sw128(b + 32 * k), (kb | k) != 0);
        }
      }
      hopper::wgmma_commit();
      hopper::fence_regs(acc);
      if constexpr (Code::kRegsA) hopper::fence_regs(f);
      if (kb > 0) {
        // the previous k-block's products are done: hand its stage back
        hopper::wgmma_wait<1>();
        hopper::fence_regs(acc);
        if constexpr (Code::kRegsA) hopper::fence_regs(g);
        if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };

    for (int s = 0; s < nsl; ++s) {
      const auto rw0 = epilogue.row(row0 + s * kLanes + r_lo);
      const auto rw1 = epilogue.row(row0 + s * kLanes + r_lo + 8);
      for (int kb = 0; kb < kblocks; kb += 2) {
        issue(kb, fa, fb);
        issue(kb + 1, fb, fa);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if constexpr (Code::kRegsA) {
        hopper::fence_regs(fa);
        hopper::fence_regs(fb);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int32_t key = epilogue.key(acc[i], (i & 2) ? rw1 : rw0, s);
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

template <int BN, bool kStream, typename C>
int launch_bf16_layout(const CUtensorMap& qmap, const CUtensorMap& cmap, const AffineKey& epilogue,
                       int32_t* out, int qp, int n, int d, int nsl, cudaStream_t stream) {
  const int smem = bf16_smem_bytes(Codes<C>::kBytes, BN, d, kStream);
  const auto kernel = binmax_scan_bf16_kernel<BN, kStream, C>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((qp + BN - 1) / BN, n / (nsl * kLanes));
  kernel<<<grid, kBf16Threads, smem, stream>>>(qmap, cmap, epilogue, out, qp, n, d, nsl);
  return static_cast<int>(cudaGetLastError());
}

// The wrapper's plan (fused_scan.bf16_query_tile): 32, 64 or 128 queries,
// resident or streamed, or 96 resident.
template <typename C>
int launch_bf16(const void* q, const void* c, const AffineKey& epilogue, int32_t* out, int qp,
                int n, int d, int nsl, int qtile, bool stream, cudaStream_t cs) {
  if (d <= 0 || d % 128 != 0) return kBadArgument;
  CUtensorMap qmap, cmap;
  if (!hopper::tile_map_u8(&qmap, q, qp, 2ull * d, qtile) || !Codes<C>::map(&cmap, c, n, d)) {
    return kTensorMapFailed;
  }
  const auto& e = epilogue;
  switch (qtile) {
    case 32:
      return stream ? launch_bf16_layout<32, true, C>(qmap, cmap, e, out, qp, n, d, nsl, cs)
                    : launch_bf16_layout<32, false, C>(qmap, cmap, e, out, qp, n, d, nsl, cs);
    case 64:
      return stream ? launch_bf16_layout<64, true, C>(qmap, cmap, e, out, qp, n, d, nsl, cs)
                    : launch_bf16_layout<64, false, C>(qmap, cmap, e, out, qp, n, d, nsl, cs);
    case 96:
      return stream ? kBadArgument
                    : launch_bf16_layout<96, false, C>(qmap, cmap, e, out, qp, n, d, nsl, cs);
    case 128:
      return stream ? launch_bf16_layout<128, true, C>(qmap, cmap, e, out, qp, n, d, nsl, cs)
                    : launch_bf16_layout<128, false, C>(qmap, cmap, e, out, qp, n, d, nsl, cs);
    default:
      return kBadArgument;
  }
}

// -- exact f32 operands: the SIMT loop ------------------------------------------------

constexpr int kBK = 64;                   // elements of D a stage carries
constexpr int kF32Stages = 2;             // cp.async stages in flight
constexpr int kQRowBytes = kBK * 4 + 16;  // padded query row: 68 words, conflict-free

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A code row of the stage in shared memory, padded so that eight
// consecutive rows read at one offset fall on distinct banks; get()
// widens four elements from k4 * 4 on to f32.
template <typename C>
struct SimtCodes;

template <>
struct SimtCodes<float> {
  static constexpr int kRowBytes = kBK * 4 + 16;
  __device__ __forceinline__ static float4 get(const uint8_t* row, int k4) {
    return *reinterpret_cast<const float4*>(row + k4 * 16);
  }
};

template <>
struct SimtCodes<__nv_bfloat16> {
  static constexpr int kRowBytes = kBK * 2 + 16;
  __device__ __forceinline__ static float4 get(const uint8_t* row, int k4) {
    const uint2 v = *reinterpret_cast<const uint2*>(row + k4 * 8);
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xFFFF0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xFFFF0000u));
  }
};

template <>
struct SimtCodes<__nv_fp8_e4m3> {
  static constexpr int kRowBytes = kBK + 16;
  __device__ __forceinline__ static float e4m3(uint32_t w, int i) {
    __nv_fp8_e4m3 e;
    e.__x = static_cast<__nv_fp8_storage_t>((w >> (8 * i)) & 0xFFu);
    return static_cast<float>(e);  // exact
  }
  __device__ __forceinline__ static float4 get(const uint8_t* row, int k4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + k4 * 4);
    return make_float4(e4m3(w, 0), e4m3(w, 1), e4m3(w, 2), e4m3(w, 3));
  }
};

// acc[i][j] += a[i] . b[j] over four elements of D, in order. Each pass
// over the tile is TM x TN independent FMAs: a warp issues in order, so
// an FMA that waited for the one before it would stall the warp.
template <int TM, int TN>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN], const float4 (&a)[TM],
                                         const float4 (&b)[TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
}

// A block of TQ queries x the 128 bins of a chunk; each thread holds TM
// queries x TN bins. Shared memory: kF32Stages stages of [TQ query rows,
// 128 code rows] x kBK elements, then the running max keys [TQ][128 + kNX]
// (padded: the rows a warp spans fall on distinct banks).
template <int TQ, int TM, int TN, typename C>
struct SimtTile {
  static constexpr int kNX = kLanes / TN;  // threads along the bins: tx + kNX * j
  static constexpr int kNY = TQ / TM;      // threads along the queries: ty + kNY * i
  static constexpr int kThreads = kNX * kNY;
  static constexpr int kQBytes = TQ * kQRowBytes;
  static constexpr int kStageBytes = kQBytes + kLanes * SimtCodes<C>::kRowBytes;
  static constexpr int kBestStride = kLanes + kNX;
  static constexpr int kSmem = kF32Stages * kStageBytes + TQ * kBestStride * 4;
};

// Thread (tx, ty)'s queries and code rows, elements [4 k4, 4 k4 + 4).
template <typename T, typename C, int TM, int TN>
__device__ __forceinline__ void load_fragments(const uint8_t* sq, const uint8_t* sc, int tx,
                                               int ty, int k4, float4 (&a)[TM],
                                               float4 (&b)[TN]) {
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    b[j] = SimtCodes<C>::get(sc + (tx + T::kNX * j) * SimtCodes<C>::kRowBytes, k4);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    a[i] = *reinterpret_cast<const float4*>(sq + (ty + T::kNY * i) * kQRowBytes + 16 * k4);
  }
}

template <int TQ, int TM, int TN, typename C>
__global__ void __launch_bounds__(SimtTile<TQ, TM, TN, C>::kThreads, 1)
binmax_scan_f32_kernel(const float* __restrict__ queries, const C* __restrict__ codes,
                       const AffineKey epilogue, int32_t* __restrict__ out, int qp, int n, int d,
                       int nsl) {
  using T = SimtTile<TQ, TM, TN, C>;
  constexpr int kRB = SimtCodes<C>::kRowBytes;
  constexpr int kCodeRuns = kBK * static_cast<int>(sizeof(C)) / 16;  // 16-byte copies a row
  constexpr int kQueryRuns = kBK * 4 / 16;
  extern __shared__ __align__(16) uint8_t smem[];
  int32_t* const best = reinterpret_cast<int32_t*>(smem + kF32Stages * T::kStageBytes);

  const int tx = threadIdx.x % T::kNX;
  const int ty = threadIdx.x / T::kNX;
  const int q0 = blockIdx.x * TQ;
  const int chunk = blockIdx.y;
  const int row_base = chunk * nsl * kLanes;
  const int ksteps = d / kBK;
  const int steps = nsl * ksteps;

  // queries [q0, q0 + TQ) and the slice's 128 code rows, elements
  // [k0, k0 + kBK); query rows at or past qp read as zeros
  auto stage_load = [&](int it) {
    if (it < steps) {
      const int s = it / ksteps;
      const int k0 = (it % ksteps) * kBK;
      uint8_t* const sq = smem + (it % kF32Stages) * T::kStageBytes;
      uint8_t* const sc = sq + T::kQBytes;
      for (int i = threadIdx.x; i < TQ * kQueryRuns + kLanes * kCodeRuns; i += T::kThreads) {
        if (i < TQ * kQueryRuns) {
          const int r = i / kQueryRuns;
          const int c = i % kQueryRuns;
          const int q = q0 + r;
          const float* src = queries + static_cast<size_t>(q < qp ? q : qp - 1) * d + k0 + 4 * c;
          cp_async16(sq + r * kQRowBytes + 16 * c, src, q < qp ? 16 : 0);
        } else {
          const int r = (i - TQ * kQueryRuns) / kCodeRuns;
          const int c = (i - TQ * kQueryRuns) % kCodeRuns;
          const C* src = codes + static_cast<size_t>(row_base + s * kLanes + r) * d + k0;
          cp_async16(sc + r * kRB + 16 * c, reinterpret_cast<const uint8_t*>(src) + 16 * c, 16);
        }
      }
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int p = 0; p < kF32Stages - 1; ++p) stage_load(p);
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // stage it landed for all; stage it - 1 is free
    stage_load(it + kF32Stages - 1);
    const uint8_t* const sq = smem + (it % kF32Stages) * T::kStageBytes;
    const uint8_t* const sc = sq + T::kQBytes;
    // fragments of k4 + 1 load while k4's products run
    float4 a[2][TM], b[2][TN];
    load_fragments<T, C>(sq, sc, tx, ty, 0, a[0], b[0]);
#pragma unroll
    for (int k4 = 0; k4 < kBK / 4; ++k4) {
      if (k4 + 1 < kBK / 4) {
        load_fragments<T, C>(sq, sc, tx, ty, k4 + 1, a[(k4 + 1) & 1], b[(k4 + 1) & 1]);
      }
      fma_tile(acc, a[k4 & 1], b[k4 & 1]);
    }
    if ((it + 1) % ksteps == 0) {
      // the slice is summed: its keys join the running max, which each
      // thread keeps for its own (query, bin) pairs
      const int s = it / ksteps;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const auto rw = epilogue.row(row_base + s * kLanes + tx + T::kNX * j);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int32_t key = epilogue.key(acc[i][j], rw, s);
          int32_t* const b = best + (ty + T::kNY * i) * T::kBestStride + tx + T::kNX * j;
          *b = (s == 0) ? key : max(*b, key);
          acc[i][j] = 0.0f;
        }
      }
    }
  }

  __syncthreads();
  const int nbins = (n / (nsl * kLanes)) * kLanes;
  for (int v = threadIdx.x; v < TQ * (kLanes / 4); v += T::kThreads) {
    const int q = v / (kLanes / 4);
    const int c = v % (kLanes / 4);
    if (q0 + q < qp) {
      *reinterpret_cast<int4*>(out + static_cast<size_t>(q0 + q) * nbins + chunk * kLanes +
                               c * 4) =
          *reinterpret_cast<const int4*>(best + q * T::kBestStride + c * 4);
    }
  }
}

template <int TQ, int TM, int TN, typename C>
int launch_f32_tile(const void* q, const void* c, const AffineKey& epilogue, int32_t* out, int qp,
                    int n, int d, int nsl, cudaStream_t stream) {
  using T = SimtTile<TQ, TM, TN, C>;
  const auto kernel = binmax_scan_f32_kernel<TQ, TM, TN, C>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((qp + TQ - 1) / TQ, n / (nsl * kLanes));
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(static_cast<const float*>(q),
                                                  static_cast<const C*>(c), epilogue, out, qp,
                                                  n, d, nsl);
  return static_cast<int>(cudaGetLastError());
}

// The wrapper's plan (fused_scan.exact_query_tile): 16, 32, 64 or 128
// queries a block, each thread TM x TN of them.
template <typename C>
int launch_f32(const void* q, const void* c, const AffineKey& epilogue, int32_t* out, int qp,
               int n, int d, int nsl, int qtile, cudaStream_t stream) {
  if (d <= 0 || d % kBK != 0) return kBadArgument;
  switch (qtile) {
    case 16:
      return launch_f32_tile<16, 2, 4, C>(q, c, epilogue, out, qp, n, d, nsl, stream);
    case 32:
      return launch_f32_tile<32, 4, 4, C>(q, c, epilogue, out, qp, n, d, nsl, stream);
    case 64:
      return launch_f32_tile<64, 4, 8, C>(q, c, epilogue, out, qp, n, d, nsl, stream);
    case 128:
      return launch_f32_tile<128, 8, 8, C>(q, c, epilogue, out, qp, n, d, nsl, stream);
    default:
      return kBadArgument;
  }
}

bool bad_shape(int qp, int n, int nsl) {
  return qp <= 0 || n <= 0 || nsl <= 0 || n % (nsl * kLanes) != 0;
}

}  // namespace

// K1 on bf16 operands: queries [qp, d] bf16 (k-blocks permuted for f8 and
// f32 codes), codes [n, d] e4m3 / bf16 / f32.
extern "C" int coltt_binmax_scan_bf16(int code_dtype, const void* queries, const void* codes,
                                      const float* rowmul, const float* rowadd, int32_t* out,
                                      int qp, int n, int d, int nsl, int qtile,
                                      int stream_queries, void* stream) {
  if (bad_shape(qp, n, nsl)) return kBadArgument;
  const AffineKey e{rowmul, rowadd, -nsl};
  const bool sq = stream_queries != 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (code_dtype) {
    case kCodeFp8:
      return launch_bf16<__nv_fp8_e4m3>(queries, codes, e, out, qp, n, d, nsl, qtile, sq, s);
    case kCodeBf16:
      return launch_bf16<__nv_bfloat16>(queries, codes, e, out, qp, n, d, nsl, qtile, sq, s);
    case kCodeFp32:
      return launch_bf16<float>(queries, codes, e, out, qp, n, d, nsl, qtile, sq, s);
    default:
      return kBadArgument;
  }
}

// K1 on exact f32 operands: queries [qp, d] f32, codes [n, d] e4m3 / bf16 /
// f32 (widened exactly).
extern "C" int coltt_binmax_scan_f32(int code_dtype, const void* queries, const void* codes,
                                     const float* rowmul, const float* rowadd, int32_t* out,
                                     int qp, int n, int d, int nsl, int qtile, void* stream) {
  if (bad_shape(qp, n, nsl)) return kBadArgument;
  const AffineKey e{rowmul, rowadd, -nsl};
  auto s = static_cast<cudaStream_t>(stream);
  switch (code_dtype) {
    case kCodeFp8:
      return launch_f32<__nv_fp8_e4m3>(queries, codes, e, out, qp, n, d, nsl, qtile, s);
    case kCodeBf16:
      return launch_f32<__nv_bfloat16>(queries, codes, e, out, qp, n, d, nsl, qtile, s);
    case kCodeFp32:
      return launch_f32<float>(queries, codes, e, out, qp, n, d, nsl, qtile, s);
    default:
      return kBadArgument;
  }
}

extern "C" const char* coltt_error_string(int code) { return error_string(code); }
