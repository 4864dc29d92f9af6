// Hand-written CUDA kernels for the planner-path Neural Laplace forward (sm_90a).
//
// nl_forward_kernel replaces neurallaplacecontrol_tpu/ops/pallas_nl.py::_nl_forward_kernel:
// raw obs [B, n] and the raw flattened action buffer [B, A*in] -> state difference [B, D],
// for operands folded on the host by pack_nl_forward. It runs a 2-layer GRU over the
// buffer newest to oldest, the encoder head, the two tanh trunk layers and the
// theta/phi head with the fourier ILT combine.
//
// nl_head_kernel replaces neurallaplacecontrol_tpu/ops/pallas_ilt.py::_nl_head_kernel:
// hidden [B, Hx] -> state difference [B, D]. Its math is nl_head_tile, the device function
// that ends nl_forward_kernel as well.
//
// Design. One CTA of kThreads threads owns kRows batch rows and keeps every activation in
// shared memory. Each GEMM gives one output column to a thread, which streams that column
// of the weight matrix once (coalesced across the warp, served from L2 after the first
// CTA: the weights are ~0.5 MB) and holds kRows accumulators in registers. The fourier
// combine is the 17-term weighted sum per (row, d) that the TPU kernel wrote as a GEMM
// against selection matrices; it reads the weights off the diagonal of those matrices,
// so both kernels take pack_nl_forward's operands unchanged.
//
// Bound. At B=1000 the forward does ~0.38 GFLOP of f32 multiply-adds against ~0.5 MB of
// weights, so it is bound by operations (about 6 us at the H100's 67 TFLOP/s f32 peak).
// This first version runs the FMAs on the CUDA cores with every weight re-read by each
// CTA; wgmma tiles and weight reuse across more rows are later work.
//
// Numerics: f32 throughout with the accurate tanhf/sinf/cosf/expf (no fast-math), since
// the ILT tail amplifies error near phi ~ pi/2 (pallas_nl.py:46-60).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;         // batch rows per CTA
constexpr int kThreads = 256;
constexpr int kMaxObs = 16;      // state dim n
constexpr int kMaxActs = 32;     // A * in
constexpr int kMaxH = 64;        // GRU hidden size
constexpr int kMaxHid = 128;     // trunk width (and the head's input width)
constexpr int kMaxHeadCols = 192;  // D * terms
constexpr int kLatent = 2;       // action latent
constexpr int kScratch = (3 * kMaxHeadCols > 6 * kMaxH) ? 3 * kMaxHeadCols : 6 * kMaxH;

constexpr double kPi = 3.14159265358979323846;
constexpr double kPhiMargin = 1e-4;  // ops/sphere.py _PHI_MARGIN
constexpr float kPiF = static_cast<float>(kPi);
constexpr float kHalfPiF = static_cast<float>(kPi / 2.0);
constexpr float kPhiLoF = static_cast<float>(-kPi / 2.0 + kPhiMargin);
constexpr float kPhiHiF = static_cast<float>(kPi / 2.0 - kPhiMargin);

struct HeadArgs {
  const float* w_theta;  // [Hx, N], column d*Tp + t
  const float* w_phi;    // [Hx, N]
  const float* b_theta;  // [N]
  const float* b_phi;    // [N]
  const float* s_re;     // [N, Dp], weight of term t for output d at row d*Tp + t, column d
  const float* s_im;     // [N, Dp]
  int D, terms, Tp, N, Dp;
};

struct ForwardArgs {
  const float* w_ih1; const float* w_hh1; const float* b_ih1; const float* b_hh1;
  const float* w_ih2; const float* w_hh2; const float* b_ih2; const float* b_hh2;
  const float* w_enc; const float* b_enc;
  const float* w1_obs; const float* w1_act; const float* b1;
  const float* w2; const float* b2;
  HeadArgs head;
  int B, n, A, in_dim, H, hid;
};

// out[r, j] = act(acc(r, j) + bias[col(j)] + sum_k in[r, k] * W[k, col(j)]) for r < kRows and
// j < ncols, where col(j) = (j / group) * group_stride + j % group picks the live columns of a
// padded layout, and acc is out[r, j] when accumulate is set, else 0. Each thread owns a
// column; the kRows activation rows are broadcast from shared memory.
__device__ void rows_gemm(const float* in, int ld_in, int K,
                          const float* __restrict__ W, int ldw,
                          const float* __restrict__ bias,
                          int ncols, int group, int group_stride,
                          float* out, int ld_out, bool accumulate, bool apply_tanh) {
  for (int j = threadIdx.x; j < ncols; j += blockDim.x) {
    const int col = (j / group) * group_stride + (j % group);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = W[k * ldw + col];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(in[r * ld_in + k], w, acc[r]);
    }
    const float b = bias ? bias[col] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float v = accumulate ? out[r * ld_out + j] + acc[r] : acc[r];
      v += b;
      out[r * ld_out + j] = apply_tanh ? tanhf(v) : v;
    }
  }
}

__device__ __forceinline__ float logisticf(float x) { return 1.f / (1.f + expf(-x)); }

// GRU gates (r/z/n blocks, models/common.py gru_gates): h <- (1 - z) n + z h.
__device__ void gru_update(const float* gi, const float* gh, float* h, int H) {
  for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
    const int r = idx / H;
    const int c = idx % H;
    const float* gir = gi + r * 3 * H;
    const float* ghr = gh + r * 3 * H;
    const float rg = logisticf(gir[c] + ghr[c]);
    const float z = logisticf(gir[H + c] + ghr[H + c]);
    const float nn = tanhf(gir[2 * H + c] + rg * ghr[2 * H + c]);
    h[idx] = (1.f - z) * nn + z * h[idx];
  }
}

// The head and the fourier combine for the kRows rows in x [kRows, Hx] (shared memory):
// theta = tanh(.) pi, phi = clip(tanh(.) pi/2), F = r e^{i theta} with the per-hemisphere
// radius, out[row0 + r, d] = sum_t Re(F w_t) for the live rows. scratch holds 3 kRows*D*terms.
__device__ void nl_head_tile(const float* x, int Hx, const HeadArgs& a, float* scratch,
                             float* __restrict__ out, int row0, int B) {
  const int ncols = a.D * a.terms;
  float* g_theta = scratch;
  float* g_phi = scratch + kRows * ncols;
  float* contrib = scratch + 2 * kRows * ncols;
  rows_gemm(x, Hx, Hx, a.w_theta, a.N, a.b_theta, ncols, a.terms, a.Tp, g_theta, ncols, false, false);
  rows_gemm(x, Hx, Hx, a.w_phi, a.N, a.b_phi, ncols, a.terms, a.Tp, g_phi, ncols, false, false);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * ncols; idx += blockDim.x) {
    const int j = idx % ncols;
    const int d = j / a.terms;
    const int t = j % a.terms;
    const float theta = tanhf(g_theta[idx]) * kPiF;
    const float phi = fminf(fmaxf(tanhf(g_phi[idx]) * kHalfPiF, kPhiLoF), kPhiHiF);
    const float sin_phi = sinf(phi);
    const float cos_phi = cosf(phi);
    const float radius = phi >= 0.f ? (1.f + sin_phi) / cos_phi : cos_phi / (1.f - sin_phi);
    const float f_re = radius * cosf(theta);
    const float f_im = radius * sinf(theta);
    const int srow = (d * a.Tp + t) * a.Dp + d;
    contrib[idx] = f_re * a.s_re[srow] - f_im * a.s_im[srow];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kRows * a.D; idx += blockDim.x) {
    const int r = idx / a.D;
    const int d = idx % a.D;
    if (row0 + r >= B) continue;
    const float* c = contrib + r * ncols + d * a.terms;
    float acc = 0.f;
    for (int t = 0; t < a.terms; ++t) acc += c[t];
    out[(row0 + r) * a.D + d] = acc;
  }
}

__device__ void load_rows(const float* __restrict__ src, int width, int row0, int B, float* dst) {
  for (int idx = threadIdx.x; idx < kRows * width; idx += blockDim.x) {
    const int r = idx / width;
    dst[idx] = (row0 + r < B) ? src[(row0 + r) * width + idx % width] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
nl_forward_kernel(const float* __restrict__ obs, const float* __restrict__ acts,
                  ForwardArgs a, float* __restrict__ out) {
  __shared__ float s_obs[kRows * kMaxObs];
  __shared__ float s_acts[kRows * kMaxActs];
  __shared__ float s_h1[kRows * kMaxH];
  __shared__ float s_h2[kRows * kMaxH];
  __shared__ float s_pact[kRows * kLatent];
  __shared__ float s_hid1[kRows * kMaxHid];
  __shared__ float s_hid2[kRows * kMaxHid];
  __shared__ float s_scratch[kRows * kScratch];

  const int row0 = blockIdx.x * kRows;
  const int H = a.H;
  const int G = 3 * H;
  const int A_in = a.A * a.in_dim;
  load_rows(obs, a.n, row0, a.B, s_obs);
  load_rows(acts, A_in, row0, a.B, s_acts);
  for (int idx = threadIdx.x; idx < kRows * H; idx += blockDim.x) {
    s_h1[idx] = 0.f;
    s_h2[idx] = 0.f;
  }
  __syncthreads();

  float* gi = s_scratch;
  float* gh = s_scratch + kRows * G;
  // reverse GRU: consume the buffer newest -> oldest (w_nl.py:27)
  for (int step = 0; step < a.A; ++step) {
    const int src = a.A - 1 - step;
    rows_gemm(s_acts + src * a.in_dim, A_in, a.in_dim, a.w_ih1, G, a.b_ih1, G, G, G, gi, G, false, false);
    rows_gemm(s_h1, H, H, a.w_hh1, G, a.b_hh1, G, G, G, gh, G, false, false);
    __syncthreads();
    gru_update(gi, gh, s_h1, H);
    __syncthreads();
    rows_gemm(s_h1, H, H, a.w_ih2, G, a.b_ih2, G, G, G, gi, G, false, false);
    rows_gemm(s_h2, H, H, a.w_hh2, G, a.b_hh2, G, G, G, gh, G, false, false);
    __syncthreads();
    gru_update(gi, gh, s_h2, H);
    __syncthreads();
  }

  // encoder head -> action latent; trunk layer 1 (normalization and contour folded in)
  rows_gemm(s_h2, H, H, a.w_enc, kLatent, a.b_enc, kLatent, kLatent, kLatent, s_pact, kLatent,
            false, false);
  rows_gemm(s_obs, a.n, a.n, a.w1_obs, a.hid, nullptr, a.hid, a.hid, a.hid, s_hid1, a.hid,
            false, false);
  __syncthreads();
  rows_gemm(s_pact, kLatent, kLatent, a.w1_act, a.hid, a.b1, a.hid, a.hid, a.hid, s_hid1, a.hid,
            true, true);
  __syncthreads();
  rows_gemm(s_hid1, a.hid, a.hid, a.w2, a.hid, a.b2, a.hid, a.hid, a.hid, s_hid2, a.hid,
            false, true);
  __syncthreads();
  nl_head_tile(s_hid2, a.hid, a.head, s_scratch, out, row0, a.B);
}

__global__ void __launch_bounds__(kThreads)
nl_head_kernel(const float* __restrict__ x, HeadArgs a, int B, int Hx, float* __restrict__ out) {
  __shared__ float s_x[kRows * kMaxHid];
  __shared__ float s_scratch[kRows * kScratch];
  const int row0 = blockIdx.x * kRows;
  load_rows(x, Hx, row0, B, s_x);
  __syncthreads();
  nl_head_tile(s_x, Hx, a, s_scratch, out, row0, B);
}

bool head_dims_ok(const HeadArgs& h, int Hx) {
  return h.D > 0 && h.terms > 0 && h.terms <= h.Tp && h.D * h.terms <= kMaxHeadCols &&
         h.N == h.D * h.Tp && h.D <= h.Dp && Hx > 0 && Hx <= kMaxHid;
}

int grid_for(int B) { return (B + kRows - 1) / kRows; }

}  // namespace

extern "C" {

// ptrs: obs, acts, the 21 operands of pack_nl_forward in order, out (24 device pointers).
// dims: B, n, A, in_dim, H, hid, D, terms, Tp, N, Dp.
// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
int nl_forward_launch(const void* const* ptrs, int n_ptrs, const int* dims, int n_dims,
                      void* stream) {
  if (n_ptrs != 24 || n_dims != 11) return static_cast<int>(cudaErrorInvalidValue);
  const float* const* p = reinterpret_cast<const float* const*>(ptrs);
  ForwardArgs a;
  a.w_ih1 = p[2]; a.w_hh1 = p[3]; a.b_ih1 = p[4]; a.b_hh1 = p[5];
  a.w_ih2 = p[6]; a.w_hh2 = p[7]; a.b_ih2 = p[8]; a.b_hh2 = p[9];
  a.w_enc = p[10]; a.b_enc = p[11];
  a.w1_obs = p[12]; a.w1_act = p[13]; a.b1 = p[14];
  a.w2 = p[15]; a.b2 = p[16];
  a.head.w_theta = p[17]; a.head.w_phi = p[18]; a.head.b_theta = p[19]; a.head.b_phi = p[20];
  a.head.s_re = p[21]; a.head.s_im = p[22];
  a.B = dims[0]; a.n = dims[1]; a.A = dims[2]; a.in_dim = dims[3]; a.H = dims[4];
  a.hid = dims[5];
  a.head.D = dims[6]; a.head.terms = dims[7]; a.head.Tp = dims[8]; a.head.N = dims[9];
  a.head.Dp = dims[10];
  if (a.B < 0 || a.n <= 0 || a.n > kMaxObs || a.A <= 0 || a.in_dim <= 0 ||
      a.A * a.in_dim > kMaxActs || a.H <= 0 || a.H > kMaxH || a.hid <= 0 ||
      !head_dims_ok(a.head, a.hid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.B == 0) return 0;
  nl_forward_kernel<<<grid_for(a.B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p[0], p[1], a, const_cast<float*>(p[23]));
  return static_cast<int>(cudaGetLastError());
}

// ptrs: x, w_theta, w_phi, b_theta, b_phi, s_re, s_im, out (8 device pointers).
// dims: B, Hx, D, terms, Tp, N, Dp.
int nl_head_launch(const void* const* ptrs, int n_ptrs, const int* dims, int n_dims,
                   void* stream) {
  if (n_ptrs != 8 || n_dims != 7) return static_cast<int>(cudaErrorInvalidValue);
  const float* const* p = reinterpret_cast<const float* const*>(ptrs);
  HeadArgs h;
  h.w_theta = p[1]; h.w_phi = p[2]; h.b_theta = p[3]; h.b_phi = p[4];
  h.s_re = p[5]; h.s_im = p[6];
  const int B = dims[0];
  const int Hx = dims[1];
  h.D = dims[2]; h.terms = dims[3]; h.Tp = dims[4]; h.N = dims[5]; h.Dp = dims[6];
  if (B < 0 || !head_dims_ok(h, Hx)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  nl_head_kernel<<<grid_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p[0], h, B, Hx, const_cast<float*>(p[7]));
  return static_cast<int>(cudaGetLastError());
}

const char* nl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
