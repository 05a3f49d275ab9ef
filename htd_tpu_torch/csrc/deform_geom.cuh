// Shared by K3 (deform_conv.cu), K5 (deform_conv_bwd_input.cu) and K6
// (deform_conv_bwd_offset_weight.cu): the deformable conv's parameters,
// channel vectors and sample geometry.
//
// Geometry (the JAX `_bilinear_gather` and `_bilinear_gather_grad`):
//   y = (oy*stride - pad + ky*dil) + off_y, one correctly rounded float32
//   add (x likewise); inside = y > -1 && y < H && x > -1 && x < W;
//   y0 = floor(y), ly = y - y0, hy = 1 - ly (x likewise); corner q = (cy, cx)
//   of (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1) weighs
//   wy(cy) * wx(cx) with wy(0) = hy, wy(1) = ly; its derivatives are
//   d/dy = (cy ? 1 : -1) * wx(cx) and d/dx = wy(cy) * (cx ? 1 : -1) (unit
//   slope inside a floor cell; floor itself carries no gradient). A corner
//   outside the map, and every corner of a sample that is not inside, has
//   weight and derivatives 0.
// The forward and both backward kernels take their corners from this one
// function with the round-to-nearest intrinsics, so that nvcc cannot
// contract them into FMAs: floor() and the corner bounds then decide alike
// in all three, and d_offsets does not jump where the forward did not.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 9;

struct DcnParams {
  int n, h, w, cin, ho, wo, cout, cg, og, stride, pad, dil;
};

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[N]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static void load4(const float* p, float (&v)[4]) { load(p, v); }
  __device__ __forceinline__ static float one(const float* p) { return *p; }
  __device__ __forceinline__ static float from(float v) { return v; }
  __device__ __forceinline__ static void store4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&v)[N]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load4(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static __nv_bfloat16 from(float v) { return __float2bfloat16_rn(v); }
  __device__ __forceinline__ static void store4(__nv_bfloat16* p, const float (&v)[4]) {
    uint2 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = x;
  }
};

// The four bilinear corners of one sample: flat pixel index in the (H, W)
// map, weight, and the weight's derivatives along y and x. Corners that do
// not count have weight and derivatives 0 and index 0.
struct Corners {
  int idx[4];
  float w[4], dwy[4], dwx[4];
};

__device__ __forceinline__ Corners no_corners() {
  Corners c;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    c.idx[q] = 0;
    c.w[q] = c.dwy[q] = c.dwx[q] = 0.0f;
  }
  return c;
}

// Sample of tap (ky, kx) at output pixel (oy, ox) moved by (dy, dx).
__device__ __forceinline__ Corners sample_corners(int oy, int ox, int ky, int kx, float dy,
                                                  float dx, const DcnParams& p) {
  Corners c = no_corners();
  const float ys = __fadd_rn((float)(oy * p.stride - p.pad + ky * p.dil), dy);
  const float xs = __fadd_rn((float)(ox * p.stride - p.pad + kx * p.dil), dx);
  if (!(ys > -1.0f && ys < (float)p.h && xs > -1.0f && xs < (float)p.w)) return c;
  const float y0 = floorf(ys), x0 = floorf(xs);
  const float ly = __fsub_rn(ys, y0), lx = __fsub_rn(xs, x0);
  const float hy = __fsub_rn(1.0f, ly), hx = __fsub_rn(1.0f, lx);
  const int yi = (int)y0, xi = (int)x0;
  const bool y_ok[2] = {yi >= 0, yi + 1 < p.h};
  const bool x_ok[2] = {xi >= 0, xi + 1 < p.w};
  const float wy[2] = {hy, ly}, wx[2] = {hx, lx};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int cy = q >> 1, cx = q & 1;
    if (y_ok[cy] && x_ok[cx]) {
      c.idx[q] = (yi + cy) * p.w + xi + cx;
      c.w[q] = __fmul_rn(wy[cy], wx[cx]);
      c.dwy[q] = cy ? wx[cx] : -wx[cx];
      c.dwx[q] = cx ? wy[cy] : -wy[cy];
    }
  }
  return c;
}

// Fills the parameters from the host's shape arguments; false on
// arguments the kernels do not take (dtype 0 = float32, 1 = bfloat16).
inline bool fill_params(DcnParams& p, int n, int h, int w, int cin, int ho, int wo, int cout,
                        int groups, int stride, int pad, int dil, int dtype) {
  if (dtype != 0 && dtype != 1) return false;
  if (n < 1 || h < 1 || w < 1 || ho < 1 || wo < 1 || groups < 1 || n > 65535) return false;
  if (cin % groups || cout % groups) return false;
  p.n = n; p.h = h; p.w = w; p.cin = cin; p.ho = ho; p.wo = wo; p.cout = cout;
  p.cg = cin / groups; p.og = cout / groups;
  p.stride = stride; p.pad = pad; p.dil = dil;
  return true;
}

}  // namespace
