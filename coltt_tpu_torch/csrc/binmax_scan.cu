// K1's int8 loop and K2: fused scans with one packed survivor per bin,
// for Hopper (sm_90a). K1's float-code loops are in binmax_scan_float.cu.
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

#include <cuda_runtime.h>

#include <cstdint>

#include "binmax_common.cuh"
#include "hopper.cuh"

namespace {

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

}  // namespace

// K1 on int8 codes. qtile: 32, 64 or 128 queries a block.
extern "C" int coltt_binmax_scan_s8(const void* queries, const void* codes, const float* rowmul,
                                    const float* rowadd, int32_t* out, int qp, int n, int d,
                                    int nsl, int qtile, void* stream) {
  if (qp <= 0 || n <= 0 || nsl <= 0 || n % (nsl * kLanes) != 0) return kBadArgument;
  return launch_s8(qtile, queries, codes, AffineKey{rowmul, rowadd, -nsl}, out, qp, n, d, nsl,
                   static_cast<cudaStream_t>(stream));
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

extern "C" const char* coltt_error_string(int code) { return error_string(code); }
