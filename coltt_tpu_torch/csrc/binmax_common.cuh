// What K1's loops share: binmax_scan.cu (int8 codes, and K2) and
// binmax_scan_float.cu (f8, bf16 and f32 codes) each build into a library
// of their own and include this header.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kLanes = 128;  // bins per chunk = rows per slice
constexpr int kBadArgument = -1;
constexpr int kTensorMapFailed = -2;

// Code dtypes, as fused_scan.py numbers them.
enum : int { kCodeInt8 = 0, kCodeFp8 = 1, kCodeBf16 = 2, kCodeFp32 = 3 };

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

const char* error_string(int code) {
  if (code == kBadArgument) return "coltt_binmax_scan: bad argument";
  if (code == kTensorMapFailed) return "coltt_binmax_scan: cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace
