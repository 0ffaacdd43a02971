// DISORT's layer doubling: each (column, layer, wavenumber) element's
// diffuse reflection and transmission operators, built from the
// single-scattering initializer of a thin sub-layer by k matrix doublings,
// k the element's own doubling count.
//
// Replaces no Pallas kernel: the JAX package's discrete-ordinates solver
// (grtcode_tpu/solvers/disort.py) is plain JAX.  The port ran the same
// loop as batched library products and solves (solvers/disort.py
// ::layer_operators_plain): all 37 doublings on every element, each
// discarded by a mask where the element's count was reached, about 40
// launches a doubling, and every h x h intermediate a round trip through
// device memory in 32 x 32 library tiles.  This kernel keeps an element's
// operators in registers through its doublings, runs only the doublings
// its optical depth needs and writes each result once.
//
// What bounds it on the card: f32 arithmetic, and in this design the warp
// shuffles that move rows between lanes.  A doubling of one element with
// h streams a hemisphere is six h x h products, an LU with partial
// pivoting, a solve with h + 1 right-hand sides and four matrix-vector
// products: about 9,000 operations at h = 8, against about 660 bytes read
// and written once per element (its inputs and moments, then R, T, sr, st
// and d), so operations bound it.
//
// Work split.  H = h lanes own one element, lane r row r of R, of Tt (the
// scattered part of T = diag(E) + Tt), of sr and of st; a warp holds
// 32 / H elements, consecutive in the (column, layer, wavenumber) order of
// the inputs, so neighbouring wavenumbers of one layer, whose counts are
// alike.  A product A @ B fetches row kk of B from lane kk, one shuffle an
// entry; the LU keeps each row in its lane, finds the pivot with a
// butterfly max over the lanes and broadcasts the pivot row.  A warp loops
// to its largest count; an element past its own count computes the step
// and keeps its operators, as the masked loop did.  Lane 0 of each warp
// adds those lockstep element-steps, the warp's largest count times its
// elements, to the caller's int64 counter (metrics.DoublingCounts' run),
// one atomic a warp.
//
// Arithmetic.  Each step is the plain loop's: E and d from exp(ln2 * i),
// m = I - R R, one solve of m for [R RT | rhs], then Sd, RS, R_n, Tt_n, U,
// sr_n and st_n in the same expressions, all in f32 on the CUDA cores
// (no tensor cores), built with -fmad=false like the port's other
// kernels.  The products sum in order of kk, and the LU pivots on the
// first largest entry and scales by the pivot's reciprocal, as LAPACK's
// getrf does, so the results differ from the library's only by rounding.
// The initializer (phase matrices from the delta-M moments chi, then the
// single-scattering R, Tt, sr and st) is built here too, so the two
// (h x h) phase matrices of every element never reach device memory.
//
// Built with nvcc for sm_90a into a shared library with a plain C entry
// point (no PyTorch headers); no fast-math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// Lane kk's v, within groups of H lanes.
template <int H>
__device__ __forceinline__ float lane(float v, int kk) {
  return __shfl_sync(kFull, v, kk, H);
}

// Solve m X = x for the lanes' rows: lane r holds row r of m (a) and of
// x, and is left with row r of X.  LU with partial pivoting: each row
// stays in its lane, and the pivot order is kept in piv.
template <int H>
__device__ __forceinline__ void solve(float (&a)[H], float (&x)[H + 1],
                                      int r) {
  int step = H;   // the column at which this lane's row was the pivot
  int piv[H];
#pragma unroll
  for (int c = 0; c < H; ++c) {
    // The first largest |a[., c]| among the rows not yet pivots; a NaN
    // counts as infinite, so every lane agrees on the pivot.
    float v = step < H ? -1.0f : fabsf(a[c]);
    if (isnan(v)) v = INFINITY;
    int p = r;
#pragma unroll
    for (int off = H / 2; off > 0; off /= 2) {
      const float ov = __shfl_xor_sync(kFull, v, off, H);
      const int op = __shfl_xor_sync(kFull, p, off, H);
      if (ov > v || (ov == v && op < p)) {
        v = ov;
        p = op;
      }
    }
    piv[c] = p;
    const float inv = 1.0f / lane<H>(a[c], p);
    if (r == p) step = c;
    const bool below = step == H;
    const float l = a[c] * inv;
#pragma unroll
    for (int j = c + 1; j < H; ++j) {
      const float pj = lane<H>(a[j], p);
      if (below) a[j] -= l * pj;
    }
#pragma unroll
    for (int j = 0; j <= H; ++j) {
      const float pj = lane<H>(x[j], p);
      if (below) x[j] -= l * pj;
    }
  }
  // Back substitution, column by column from the last: the pivot row of
  // column c gives X's row c, which every row pivoted before c then
  // subtracts.
  float out[H + 1];
#pragma unroll
  for (int j = 0; j <= H; ++j) out[j] = 0.0f;
#pragma unroll
  for (int c = H - 1; c >= 0; --c) {
    const int p = piv[c];
    const float inv = 1.0f / lane<H>(a[c], p);
    float sol[H + 1];
#pragma unroll
    for (int j = 0; j <= H; ++j) sol[j] = lane<H>(x[j], p) * inv;
    if (r == c) {
#pragma unroll
      for (int j = 0; j <= H; ++j) out[j] = sol[j];
    }
    if (step < c) {
#pragma unroll
      for (int j = 0; j <= H; ++j) x[j] -= a[c] * sol[j];
    }
  }
#pragma unroll
  for (int j = 0; j <= H; ++j) x[j] = out[j];
}

template <int H>
__global__ void __launch_bounds__(kThreads) disort_doubling_kernel(
    const float* __restrict__ dtau, const float* __restrict__ omega,
    const float* __restrict__ chi, const float* __restrict__ count,
    const float* __restrict__ mu0, const float* __restrict__ beam_p,
    const float* __restrict__ beam_m, const float* __restrict__ mu,
    const float* __restrict__ wq, const float* __restrict__ ppp,
    const float* __restrict__ ppm, float* __restrict__ R_out,
    float* __restrict__ T_out, float* __restrict__ sr_out,
    float* __restrict__ st_out, float* __restrict__ d_out,
    unsigned long long* __restrict__ run, int64_t n, int64_t per_column,
    float ln2) {
  constexpr int L1 = 2 * H + 1;   // Legendre moments 0..nstr
  const int r = threadIdx.x & (H - 1);
  const int64_t slot = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / H;
  // Lanes past the last element stand in for it with a count of 0: they
  // take part in the shuffles and write nothing.
  const bool valid = slot < n;
  const int64_t e = valid ? slot : n - 1;
  const int64_t b = e / per_column;
  const int k = valid ? (int)count[e] : 0;
  const int kmax = (int)__reduce_max_sync(kFull, (unsigned)k);
  const unsigned elements = __popc(__ballot_sync(kFull, valid)) / H;
  if (run != nullptr && (threadIdx.x & 31) == 0)
    atomicAdd(run, (unsigned long long)kmax * elements);

  const float mu_r = mu[r];

  // The initializer: single scattering in a sub-layer of depth dt.
  const float dt = dtau[e];
  const float x = (dt * omega[e] * 0.5f) / mu_r;
  float pp[H], pm[H];
#pragma unroll
  for (int j = 0; j < H; ++j) pp[j] = pm[j] = 0.0f;
  float bp = 0.0f, bm = 0.0f;
  const float* chi_e = chi + e * L1;
#pragma unroll
  for (int l = 0; l < L1; ++l) {
    const float c = chi_e[l];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      pp[j] += c * ppp[(l * H + r) * H + j];
      pm[j] += c * ppm[(l * H + r) * H + j];
    }
    bp += c * beam_p[(b * L1 + l) * H + r];
    bm += c * beam_m[(b * L1 + l) * H + r];
  }
  float R[H], Tt[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    Tt[j] = x * pp[j] * wq[j];
    R[j] = x * pm[j] * wq[j];
  }
  float sr = x * bp, st = x * bm;

  const float m0 = mu0[b];
  for (int i = 0; i < kmax; ++i) {
    // E (diffuse, diagonal) and d (direct) at sub-layer depth dt 2^i;
    // lane j computes E's entry j.
    const float t = dt * expf(ln2 * (float)i);
    const float Er = expf(-t / mu_r);
    const float d = expf(-t / m0);
    float E[H];
#pragma unroll
    for (int j = 0; j < H; ++j) E[j] = lane<H>(Er, j);

    // m = I - R R and RT = R diag(E) + R Tt (= R T_full).
    float m[H], RT[H];
#pragma unroll
    for (int j = 0; j < H; ++j) m[j] = RT[j] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < H; ++kk) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        m[j] += R[kk] * lane<H>(R[j], kk);
        RT[j] += R[kk] * lane<H>(Tt[j], kk);
      }
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
      m[j] = (j == r ? 1.0f : 0.0f) - m[j];
      RT[j] = R[j] * E[j] + RT[j];
    }
    // One solve for both right-hand sides: [R RT | st + R (sr d)].
    const float srd = sr * d;
    float X[H + 1];
#pragma unroll
    for (int j = 0; j <= H; ++j) X[j] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < H; ++kk) {
#pragma unroll
      for (int j = 0; j < H; ++j) X[j] += R[kk] * lane<H>(RT[j], kk);
      X[H] += R[kk] * lane<H>(srd, kk);
    }
    X[H] = st + X[H];
    solve<H>(m, X, r);

    // Sd = M T_full - diag(E) = Tt + M R RT; D = M rhs.
    float Sd[H];
#pragma unroll
    for (int j = 0; j < H; ++j) Sd[j] = Tt[j] + X[j];
    const float D = X[H];
    // RS = R diag(E) + R Sd and Tt Sd; U = R D + sr d; Tt U and Tt D.
    float RS[H], TS[H];
#pragma unroll
    for (int j = 0; j < H; ++j) RS[j] = TS[j] = 0.0f;
    float U = 0.0f, TD = 0.0f;
#pragma unroll
    for (int kk = 0; kk < H; ++kk) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float s = lane<H>(Sd[j], kk);
        RS[j] += R[kk] * s;
        TS[j] += Tt[kk] * s;
      }
      const float Dk = lane<H>(D, kk);
      U += R[kk] * Dk;
      TD += Tt[kk] * Dk;
    }
#pragma unroll
    for (int j = 0; j < H; ++j) RS[j] = R[j] * E[j] + RS[j];
    U = U + srd;
    float TU = 0.0f, TRS[H];
#pragma unroll
    for (int j = 0; j < H; ++j) TRS[j] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < H; ++kk) {
#pragma unroll
      for (int j = 0; j < H; ++j) TRS[j] += Tt[kk] * lane<H>(RS[j], kk);
      TU += Tt[kk] * lane<H>(U, kk);
    }
    // The doubled operators, kept only while i is below the count.
    if (i < k) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float rn = R[j] + Er * RS[j] + TRS[j];
        Tt[j] = Er * Sd[j] + Tt[j] * E[j] + TS[j];
        R[j] = rn;
      }
      sr = sr + Er * U + TU;
      st = st * d + Er * D + TD;
    }
  }

  // T = diag(E) + Tt and d at the layer's full depth, dt 2^k.
  const float tk = dt * expf(ln2 * (float)k);
  const float Ek = expf(-tk / mu_r);
  if (!valid) return;
  float* Re = R_out + (e * H + r) * H;
  float* Te = T_out + (e * H + r) * H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    Re[j] = R[j];
    Te[j] = Ek * (j == r ? 1.0f : 0.0f) + Tt[j];
  }
  sr_out[e * H + r] = sr;
  st_out[e * H + r] = st;
  if (r == 0) d_out[e] = expf(-tk / m0);
}

template <int H>
int launch(const float* const* in, float* const* out,
           unsigned long long* run, int64_t n, int64_t per_column, float ln2,
           cudaStream_t stream) {
  const int64_t blocks = (n * H + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  disort_doubling_kernel<H><<<(unsigned)blocks, kThreads, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], out[0], out[1], out[2], out[3], out[4], run, n, per_column,
      ln2);
  return (int)cudaGetLastError();
}

}  // namespace

// h streams a hemisphere (2, 4 or 8: nstr 4, 8 or 16); n elements, each
// column's per_column of them consecutive.  Inputs, all f32 and
// contiguous: dtau, omega, count (n), chi (n, 2h+1), mu0 (columns),
// beam_p and beam_m (columns, 2h+1, h), mu and wq (h), ppp and ppm
// (2h+1, h, h).  Outputs: R and T (n, h, h), sr and st (n, h), d (n).
// run, when not null, is an int64 on the device to which the element-steps
// the warps issue are added.
extern "C" int disort_doubling(
    int h, const void* dtau, const void* omega, const void* chi,
    const void* count, const void* mu0, const void* beam_p,
    const void* beam_m, const void* mu, const void* wq, const void* ppp,
    const void* ppm, void* R, void* T, void* sr, void* st, void* d,
    void* run, int64_t n, int64_t per_column, float ln2, void* stream) {
  if (n <= 0) return 0;
  const float* in[] = {
      (const float*)dtau,   (const float*)omega,  (const float*)chi,
      (const float*)count,  (const float*)mu0,    (const float*)beam_p,
      (const float*)beam_m, (const float*)mu,     (const float*)wq,
      (const float*)ppp,    (const float*)ppm};
  float* const out[] = {(float*)R, (float*)T, (float*)sr, (float*)st,
                        (float*)d};
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* steps = (unsigned long long*)run;
  switch (h) {
    case 2: return launch<2>(in, out, steps, n, per_column, ln2, s);
    case 4: return launch<4>(in, out, steps, n, per_column, ln2, s);
    case 8: return launch<8>(in, out, steps, n, per_column, ln2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
