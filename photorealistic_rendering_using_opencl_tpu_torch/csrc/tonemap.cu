// K2: the display transform for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photorealistic_rendering_using_opencl_tpu/
// ops/pallas_kernels.py:_tonemap_kernel (launched by tonemap_pallas):
// image x (vignette . brightness), filmic Reinhard (W = 1.2, T^2 = 7.5)
// divided by curve(W), smoothstep(-0.025, 1), clip, gamma 1/2.2.
//
// Bound: device-memory bytes, 12 B read and 12 B written per pixel (1.88 us
// at 512^2 on an H100 SXM).  Where the TPU kernel read a second,
// precomputed [H*W, 3] vignette image, this kernel computes the vignette
// weight from the pixel's coordinates inline, so it reads the HDR image
// once and writes the LDR image once.  The arithmetic is of the same order
// as the memory time (with IEEE divisions and powf a pixel took about as
// many issue slots as its bytes take on the bus), so the design cuts both:
//   - a thread takes groups of 4 consecutive pixels (12 floats: three
//     16-byte loads and three 16-byte stores), over a grid-stride loop on a
//     grid of the card's resident CTAs;
//   - one 32-bit division a group finds its row and column; the column then
//     steps across row ends.  Indices are 32-bit: the wrapper launches an
//     image of more than 2^29 pixels in bands of at most 2^29 (a multiple
//     of 4, so a band of an aligned image starts aligned), each with the
//     row and column of its first pixel; the vignette uses the whole
//     image's h and w;
//   - every division is a multiplication by an approximate reciprocal
//     (1 ulp; those of h and w once a thread, those of the constant
//     divisors rounded once from double) and the power is ex2(lg2(c) / 2.2)
//     (2^-22 each), as PTX's .approx.ftz operations: no value they see is
//     subnormal, and the curve's quotient is scaled by 2^-16 first so that
//     its reciprocal stays normal.  This keeps the kernel within 1e-6 of
//     the plain version with no fast-math flag; c = 0 gives 0.
// An input that is not 16-byte aligned (a view with a storage offset) is
// read with scalar loads by the kernel's second instance, and the last
// h*w % 4 pixels by one thread each: no input falls back to the plain
// version.  The output (the wrapper's torch.empty) must be aligned.
//
// Non-finite values propagate as in the plain version: the clips are
// PTX's max.NaN / min.NaN, which return NaN for NaN as torch.clamp and
// jnp.clip do (fminf / fmaxf would return 0), so a NaN or infinite pixel,
// or one large enough that the curve overflows, comes out NaN.
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int GROUP = 4;  // pixels a thread takes a step: 12 floats

constexpr double kW = 1.2;
constexpr double kT2 = 7.5;
constexpr float kCurveA = (float)(kT2 * kT2 + 1.0);  // 57.25
constexpr float kCurveB = (float)(kT2 * kT2);        // 56.25
// 1 / curve(W), 1 / 1.025 and the gamma exponent, evaluated in double and
// rounded once, as the reference does with its Python constants
constexpr float kInvCurveW =
    (float)(((kT2 * kT2 + 1.0) * kW * kW + kW + kT2 * kT2) /
            ((kT2 * kT2 + 1.0) * kW * kW));
constexpr float kInvToe = (float)(1.0 / 1.025);
constexpr float kInvGamma = (float)(1.0 / 2.2);

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// c^(1/2.2) for c in [0, 1] or NaN
__device__ __forceinline__ float gamma(float c) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(c));
  r *= kInvGamma;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(r));
  return r;
}

// clip to [0, 1] that keeps NaN, as torch.clamp and jnp.clip do
__device__ __forceinline__ float clip01(float x) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(x));
  asm("min.NaN.f32 %0, %1, 0f3F800000;" : "=f"(r) : "f"(r));
  return r;
}

__device__ __forceinline__ float row_coord(int y, float inv_h) {
  return 1.f - 2.f * ((float)y + 0.5f) * inv_h;
}

// vignette weight times brightness at column x of a row whose coordinate is ys
__device__ __forceinline__ float pixel_scale(int x, float ys, float inv_w,
                                             float brightness, int vignette) {
  if (!vignette) return brightness;
  const float xs = 1.f - 2.f * ((float)x + 0.5f) * inv_w;
  const float pp = ys * ys + xs * xs;
  float v = 1.25f * rcp_approx(1.1f + 1.1f * pp);
  v = v * v;
  const float t = clip01(v - 0.1f);
  return (1.f + (t * t * (3.f - 2.f * t) - 1.f) * 0.25f) * brightness;
}

// one channel: filmic Reinhard / curve(W), the toe smoothstep, gamma
__device__ __forceinline__ float display(float c) {
  const float q = kCurveA * c * c;  // +-inf past |c| ~ 2.4e18, as the reference's
  const float d = q + c + kCurveB;
  c = q * 0x1p-16f * rcp_approx(d * 0x1p-16f) * kInvCurveW;
  const float t = clip01((c + 0.025f) * kInvToe);
  return gamma(clip01(t * t * (3.f - 2.f * t)));
}

template <bool kVecLoad>
__global__ void __launch_bounds__(THREADS)
tonemap_kernel(const float* __restrict__ img, float* __restrict__ out, int h,
               int w, int y0, int x0, int groups, int tail, float brightness,
               int vignette) {
  const int stride = gridDim.x * THREADS;
  const float inv_h = rcp_approx((float)h), inv_w = rcp_approx((float)w);
  for (int g = blockIdx.x * THREADS + threadIdx.x; g < groups; g += stride) {
    float v[3 * GROUP];
    const float* src = img + 3 * GROUP * g;
    if (kVecLoad) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 a = s4[k];
        v[4 * k] = a.x, v[4 * k + 1] = a.y, v[4 * k + 2] = a.z,
        v[4 * k + 3] = a.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 3 * GROUP; ++k) v[k] = src[k];
    }
    // x0 < w and GROUP * g < 2^29, so the column sum fits 32 unsigned bits
    const unsigned pos = (unsigned)x0 + (unsigned)(GROUP * g);
    const unsigned q = pos / (unsigned)w;
    int y = y0 + (int)q;
    int x = (int)(pos - q * (unsigned)w);
    float ys = row_coord(y, inv_h);
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const float scale = pixel_scale(x, ys, inv_w, brightness, vignette);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[3 * k + c] = display(v[3 * k + c] * scale);
      if (++x == w) {
        x = 0;
        ys = row_coord(++y, inv_h);
      }
    }
    float4* d4 = reinterpret_cast<float4*>(out + 3 * GROUP * g);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d4[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
  // the last h*w % 4 pixels, one a thread of the first CTA
  if (blockIdx.x == 0 && (int)threadIdx.x < tail) {
    const int p = GROUP * groups + threadIdx.x;
    const unsigned pos = (unsigned)x0 + (unsigned)p;
    const unsigned q = pos / (unsigned)w;
    const float scale =
        pixel_scale((int)(pos - q * (unsigned)w), row_coord(y0 + (int)q, inv_h),
                    inv_w, brightness, vignette);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[3 * p + c] = display(img[3 * p + c] * scale);
  }
}

template <bool kVecLoad>
int launch(const float* img, float* out, int n, int w, int h, int y0, int x0,
           float brightness, int vignette, cudaStream_t stream) {
  const int groups = n / GROUP;
  static int cache[prt::kMaxDevices] = {};
  int ctas = 0;
  const cudaError_t e =
      prt::resident_ctas(tonemap_kernel<kVecLoad>, THREADS, cache, &ctas);
  if (e != cudaSuccess) return (int)e;
  int blocks = (groups + THREADS - 1) / THREADS;
  if (blocks > ctas) blocks = ctas;
  if (blocks < 1) blocks = 1;
  tonemap_kernel<kVecLoad><<<blocks, THREADS, 0, stream>>>(
      img, out, h, w, y0, x0, groups, n % GROUP, brightness, vignette);
  return (int)cudaGetLastError();
}

}  // namespace

// One band: the n pixels from row y0, column x0 of an h x w image (img and
// out point at that pixel).
extern "C" int prt_tonemap(const float* img, float* out, int n, int w, int h,
                           int y0, int x0, float brightness, int vignette,
                           void* stream) {
  if ((uintptr_t)out % 16 || n < 0 || n > (1 << 29) || w < 1 || x0 < 0 ||
      x0 >= w)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (uintptr_t)img % 16
             ? launch<false>(img, out, n, w, h, y0, x0, brightness, vignette, s)
             : launch<true>(img, out, n, w, h, y0, x0, brightness, vignette, s);
}
