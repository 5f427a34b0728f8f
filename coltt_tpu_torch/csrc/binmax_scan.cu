// K1 and K2: fused scans with one packed survivor per bin, for Hopper
// (sm_90a). Both share one tile loop and differ only in the epilogue that
// turns a dot into a key.
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
// Design: a block owns 64 queries x the 128 bins of one chunk and walks
// the chunk's nsl slices; each slice is a 64 x 128 product over D, staged
// through shared memory 32 words of D at a time (128 int8 values, or 32
// float values) and computed as a 4 x 8 register tile per thread with
// __dp4a (int8) or fmaf (float). The running max over slices stays in
// registers, so only [Q, N/32] keys reach device memory, not [Q, N]
// scores. Query tiles are the grid's fastest axis: the blocks that share
// a chunk run together and read its codes from L2, so the codes come from
// device memory about once per call. What bounds both kernels at serving
// shapes is the product on CUDA cores, not bytes (see fused_scan.py).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kLanes = 128;          // bins per chunk = rows per slice
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

// One 16-byte load -> 32-bit shared words. int8: 4 words of 4 packed
// values each (for __dp4a). Float codes: one f32 operand per word.
template <typename T>
struct Unpack;

template <>
struct Unpack<int8_t> {
  static constexpr int kWordsPer16 = 4;
  __device__ __forceinline__ static void run(const uint4& v, uint32_t* w, bool) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
};

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
      dot = __int2float_rn(acc);  // exact: |dot| < 2^24 for D <= 1040
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

// Elements of D one k-step covers: 128 for int8, 32 for float codes.
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

template <typename C, typename Q, typename Epilogue>
__global__ void __launch_bounds__(kThreads)
binmax_scan_kernel(const Q* __restrict__ queries, const C* __restrict__ codes,
                   const Epilogue epilogue, int32_t* __restrict__ out, int qp, int n,
                   int d, int nsl, bool round_bf16) {
  constexpr bool kInt = std::is_same<C, int8_t>::value;
  using Acc = typename std::conditional<kInt, int, float>::type;
  constexpr int kStep = step_elems<C>();
  static_assert(kStep == step_elems<Q>(), "query and code k-steps differ");

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
    Acc acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = Acc(0);

    for (int k0 = 0; k0 < d; k0 += kStep) {
      load_tile<Q>(sq, queries, kQTile, q0, qp, d, k0, round_bf16);
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
            if constexpr (kInt) {
              acc[i][j] = __dp4a(static_cast<int>(a[i]), static_cast<int>(b[j]), acc[i][j]);
            } else {
              acc[i][j] = fmaf(__uint_as_float(a[i]), __uint_as_float(b[j]), acc[i][j]);
            }
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

template <typename C, typename Q, typename Epilogue>
int launch(const void* q, const void* c, const Epilogue& epilogue, int32_t* out, int qp,
           int n, int d, int nsl, int round_bf16, cudaStream_t stream) {
  const dim3 grid((qp + kQTile - 1) / kQTile, n / (nsl * kLanes));
  binmax_scan_kernel<C, Q, Epilogue><<<grid, kThreads, 0, stream>>>(
      static_cast<const Q*>(q), static_cast<const C*>(c), epilogue, out, qp, n, d, nsl,
      round_bf16 != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Code dtypes, as fused_scan.py numbers them.
enum : int { kCodeInt8 = 0, kCodeFp8 = 1, kCodeBf16 = 2, kCodeFp32 = 3 };
constexpr int kBadArgument = -1;

extern "C" int coltt_binmax_scan(int code_dtype, const void* queries, const void* codes,
                                 const float* rowmul, const float* rowadd, int32_t* out,
                                 int qp, int n, int d, int nsl, int round_bf16,
                                 void* stream) {
  if (qp <= 0 || n <= 0 || nsl <= 0 || n % (nsl * kLanes) != 0) return kBadArgument;
  auto s = static_cast<cudaStream_t>(stream);
  const AffineKey e{rowmul, rowadd, -nsl};
  switch (code_dtype) {
    case kCodeInt8:
      if (d % step_elems<int8_t>() != 0) return kBadArgument;
      return launch<int8_t, int8_t>(queries, codes, e, out, qp, n, d, nsl, round_bf16, s);
    case kCodeFp8:
      if (d % step_elems<__nv_fp8_e4m3>() != 0) return kBadArgument;
      return launch<__nv_fp8_e4m3, float>(queries, codes, e, out, qp, n, d, nsl, round_bf16,
                                          s);
    case kCodeBf16:
      if (d % step_elems<__nv_bfloat16>() != 0) return kBadArgument;
      return launch<__nv_bfloat16, float>(queries, codes, e, out, qp, n, d, nsl, round_bf16,
                                          s);
    case kCodeFp32:
      if (d % step_elems<float>() != 0) return kBadArgument;
      return launch<float, float>(queries, codes, e, out, qp, n, d, nsl, round_bf16, s);
    default:
      return kBadArgument;
  }
}

// K2. d <= 2048 keeps (dot << log2(nsl)) + 2^30 inside int32 (fused_scan.py).
extern "C" int coltt_binmax_scan_i8(const void* queries, const void* codes, int32_t* out,
                                    int qp, int n, int d, int nsl, void* stream) {
  if (qp <= 0 || n <= 0 || nsl <= 0 || (nsl & (nsl - 1)) != 0 || n % (nsl * kLanes) != 0 ||
      d <= 0 || d > 2048 || d % step_elems<int8_t>() != 0) {
    return kBadArgument;
  }
  int sh = 0;
  while ((1 << sh) < nsl) ++sh;
  return launch<int8_t, int8_t>(queries, codes, ShiftKey{sh}, out, qp, n, d, nsl, 0,
                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* coltt_error_string(int code) {
  if (code == kBadArgument) return "coltt_binmax_scan: bad argument";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
