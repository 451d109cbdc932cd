// The sky map's bilinear lookup and its gradient, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's lookup (ops/envmap.py,
// sample_bilinear) is four XLA gathers and a blend, and its gradient XLA's
// scatter-add into the map.  The port's plain version of it, the same
// expression in PyTorch, spends a gradient step's largest kernel there: each
// of a lookup's four taps scatters its gradient with a sort-based index_put
// over every lane, dead lanes included, and walks each run of equal indices
// serially (the sky's importance sampling piles many lanes on the sun's few
// texels, and every dead lane's zero on one texel).
//
// Forward (envmap_lookup_kernel): one thread a lane.  The four taps, u
// wrapping and v clamping, blended in the plain expression's order of
// operations with no contraction (__fmul_rn, __fadd_rn, __fsub_rn), so that
// the card's result is the plain path's bit for bit.  Bound: memory, 8 B of
// (u, v) read and 12 B written a lane; the taps' 48 B come mostly from L2.
//
// Backward (envmap_grad_kernel): a grid-stride loop, one thread a lane.
// Bound: memory, 12 B of gradient a lane read, the 25 MB map written by
// atomics.  A lane whose three gradient components are all exactly zero
// makes no write and reads no (u, v) (adding zero changes no sum; a NaN or
// an inf is not zero and still propagates); each other lane sends its four
// taps' three red.global.add.f32.  Each lane's four weighted taps are formed
// as autograd forms them, (g (1 - fy)) (1 - fx), (g (1 - fy)) fx,
// (g fy) (1 - fx), (g fy) fx, so the map's gradient differs from the plain
// path's only in the order of its float additions.  Where asked (grad_u
// non-null), every lane also gives the gradients of u and v:
//   grad_u = W sum_c g_c [(c10 - c00)(1 - fy) + (c11 - c01) fy]
//   grad_v = H sum_c g_c [(c01 (1 - fx) + c11 fx) - (c00 (1 - fx) + c10 fx)]
// Where asked (counts non-null), each block writes the number of texel
// writes it made to counts[blockIdx.x].
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// torch.remainder of int32 by a positive w
__device__ __forceinline__ int wrap(int a, int w) {
  const int r = a % w;
  return r < 0 ? r + w : r;
}

// a lane's taps as the plain path computes them: the fractions, the
// corners' columns (x0, x1) and rows (y0, y1)
struct Taps {
  float fx, fy;
  int x0, x1, y0, y1;
};

__device__ __forceinline__ Taps taps(float u, float v, int h, int w) {
  const float x = __fsub_rn(__fmul_rn(u, (float)w), 0.5f);
  const float y = __fsub_rn(__fmul_rn(v, (float)h), 0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  Taps t;
  t.fx = __fsub_rn(x, x0);
  t.fy = __fsub_rn(y, y0);
  // the conversion PyTorch's .to(torch.int32) compiles to (NaN -> 0,
  // saturating)
  t.x0 = wrap(__float2int_rz(x0), w);
  t.x1 = wrap(t.x0 + 1, w);
  t.y0 = min(max(__float2int_rz(y0), 0), h - 1);
  t.y1 = min(t.y0 + 1, h - 1);
  return t;
}

// the float offset of texel (y, x) in an [h, w, 3] map
__device__ __forceinline__ long long texel(int y, int x, int w) {
  return ((long long)y * w + x) * 3;
}

__global__ void __launch_bounds__(THREADS)
envmap_lookup_kernel(const float* __restrict__ img,
                     const float* __restrict__ u, const float* __restrict__ v,
                     float* __restrict__ out, long long n, int h, int w) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Taps t = taps(u[i], v[i], h, w);
  const float* p00 = img + texel(t.y0, t.x0, w);
  const float* p10 = img + texel(t.y0, t.x1, w);
  const float* p01 = img + texel(t.y1, t.x0, w);
  const float* p11 = img + texel(t.y1, t.x1, w);
  const float gx = __fsub_rn(1.0f, t.fx), gy = __fsub_rn(1.0f, t.fy);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = __fadd_rn(__fmul_rn(__ldg(p00 + c), gx),
                              __fmul_rn(__ldg(p10 + c), t.fx));
    const float b = __fadd_rn(__fmul_rn(__ldg(p01 + c), gx),
                              __fmul_rn(__ldg(p11 + c), t.fx));
    out[3 * i + c] = __fadd_rn(__fmul_rn(a, gy), __fmul_rn(b, t.fy));
  }
}

__global__ void __launch_bounds__(THREADS)
envmap_grad_kernel(const float* __restrict__ img,
                   const float* __restrict__ u, const float* __restrict__ v,
                   const float* __restrict__ g, float* __restrict__ grad_map,
                   float* __restrict__ grad_u, float* __restrict__ grad_v,
                   long long n, int h, int w, int* __restrict__ counts) {
  __shared__ int block_writes[WARPS];
  const long long stride = (long long)gridDim.x * THREADS;
  const bool want_uv = grad_u != nullptr;
  int writes = 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float g0 = g[3 * i], g1 = g[3 * i + 1], g2 = g[3 * i + 2];
    const bool live =
        grad_map != nullptr && (g0 != 0.0f || g1 != 0.0f || g2 != 0.0f);
    if (!live && !want_uv) continue;
    const Taps t = taps(u[i], v[i], h, w);
    if (live) {
      const float gx = __fsub_rn(1.0f, t.fx), gy = __fsub_rn(1.0f, t.fy);
      // the gradient of the blend's two rows, as autograd forms it
      const float r0[3] = {__fmul_rn(g0, gy), __fmul_rn(g1, gy),
                           __fmul_rn(g2, gy)};
      const float r1[3] = {__fmul_rn(g0, t.fy), __fmul_rn(g1, t.fy),
                           __fmul_rn(g2, t.fy)};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float* r = k < 2 ? r0 : r1;
        const float f = k & 1 ? t.fx : gx;
        float* p = grad_map + texel(k < 2 ? t.y0 : t.y1, k & 1 ? t.x1 : t.x0,
                                    w);
        atomicAdd(p, __fmul_rn(r[0], f));
        atomicAdd(p + 1, __fmul_rn(r[1], f));
        atomicAdd(p + 2, __fmul_rn(r[2], f));
      }
      writes += 4;
    }
    if (want_uv) {
      const float* p00 = img + texel(t.y0, t.x0, w);
      const float* p10 = img + texel(t.y0, t.x1, w);
      const float* p01 = img + texel(t.y1, t.x0, w);
      const float* p11 = img + texel(t.y1, t.x1, w);
      const float gs[3] = {g0, g1, g2};
      const float gx = 1.0f - t.fx, gy = 1.0f - t.fy;
      float su = 0.0f, sv = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float c00 = __ldg(p00 + c), c10 = __ldg(p10 + c);
        const float c01 = __ldg(p01 + c), c11 = __ldg(p11 + c);
        su += gs[c] * ((c10 - c00) * gy + (c11 - c01) * t.fy);
        sv += gs[c] * ((c01 * gx + c11 * t.fx) - (c00 * gx + c10 * t.fx));
      }
      grad_u[i] = su * (float)w;
      grad_v[i] = sv * (float)h;
    }
  }
  if (counts == nullptr) return;
  writes = __reduce_add_sync(FULL, writes);
  if ((threadIdx.x & 31) == 0) block_writes[threadIdx.x >> 5] = writes;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) total += block_writes[k];
    counts[blockIdx.x] = total;
  }
}

}  // namespace

// out[i] = the bilinear lookup of img [h, w, 3] at (u[i], v[i]), i < n
extern "C" int prt_envmap_lookup(const float* img, const float* u,
                                 const float* v, float* out, long long n,
                                 int h, int w, void* stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  envmap_lookup_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      img, u, v, out, n, h, w);
  return (int)cudaGetLastError();
}

// The lookup's backward for grad_out g [n, 3] on a grid of `blocks` blocks:
// the map's gradient added into grad_map [h, w, 3] (zeroed by the caller;
// null: not asked for), the gradients of u and v written to grad_u and
// grad_v [n] (null: not asked for), each block's texel writes to
// counts[blocks] (null: not counted)
extern "C" int prt_envmap_lookup_grad(const float* img, const float* u,
                                      const float* v, const float* g,
                                      float* grad_map, float* grad_u,
                                      float* grad_v, long long n, int h,
                                      int w, int blocks, int* counts,
                                      void* stream) {
  envmap_grad_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      img, u, v, g, grad_map, grad_u, grad_v, n, h, w, counts);
  return (int)cudaGetLastError();
}
