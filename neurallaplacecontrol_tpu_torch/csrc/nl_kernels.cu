// Hand-written CUDA kernels for the planner-path Neural Laplace forward (sm_90a).
//
// nl_forward_kernel replaces neurallaplacecontrol_tpu/ops/pallas_nl.py::_nl_forward_kernel:
// raw obs [B, n] and the raw flattened action buffer [B, A*in] -> state difference [B, D].
// It runs a 2-layer GRU over the buffer newest to oldest, the encoder head, the two tanh
// trunk layers and the theta/phi head with the fourier ILT combine.
//
// nl_forward_streamed_kernel computes the same function for the widths whose weights do not
// fit in shared memory (see "The streamed variant" below); forward_plan picks one of the two
// from the dims, and nl_forward_launch launches it.
//
// nl_head_kernel replaces neurallaplacecontrol_tpu/ops/pallas_ilt.py::_nl_head_kernel:
// hidden [B, Hx] -> state difference [B, D]. Its math is head_tile, the device function
// that ends nl_forward_kernel as well.
//
// Both read their weights from one flat buffer laid out on the host (ops/pallas_nl.py
// repack_nl_forward, ops/pallas_ilt.py repack_head): the GRU's and the trunk's matrices in
// the register order of the A operand of mma.sync.m16n8k8.tf32, with the weights' output
// columns as its M side; the head over its D*terms live columns only, theta and phi
// interleaved, with a compact pair of combine weights, in chunks of at most kHeadStageFloats
// floats that pass through shared memory one at a time. A ragged width is zero-padded there:
// the GRU's H to a multiple of 8, the trunk's width to a multiple of 16, the head's input to a
// multiple of 4 (pad_nl_forward says why that is exact); the dims a launcher takes are the
// model's, and it pads them as the host does.
//
// Design. One CTA of 16 warps owns kRows = 8 batch rows, the N side of the MMA, so 125 CTAs
// cover B = 1000, one per SM. The GRU's and the trunk's products run on the tensor cores in
// split TF32 ("3xTF32", mma.sync.m16n8k8): x = hi + lo with hi and lo TF32 values, and
// a*b ~ hi*hi + hi*lo + lo*hi, each of the three summed in its own f32 accumulator (the
// hi*hi one by f32 adds, see mma3); one pass of TF32 errs by up to 2^-11 per operand and
// misses the 1e-3 limit. The weights are split
// in registers as they are loaded; each activation is split once, when it is computed, and
// stored as two planes. The head's two products run in f32 on the CUDA cores (see
// head_tile). The weights are staged in dynamic shared memory by bulk asynchronous copies
// (cp.async.bulk, completion on an mbarrier): the small operands and GRU layer 1 first, GRU
// layer 2 while layer 1 runs its first step, the trunk's second layer into layer 1's place
// once layer 1 is done, and the head, chunk by chunk, into layer 2's place once the GRU is
// done (one chunk up to 104 columns: 17 terms on every env take one). The GRU runs
// as a wavefront: in phase p warps 0-7 compute layer 1 at step p and warps 8-15 layer 2 at
// step p-1, warp w owning hidden units 8(w%8)..8(w%8)+7 with its r and z gates in one
// 16-column tile over [x; h] and its candidate's input and hidden halves in another, so the
// gate update happens in registers; A steps take A + 1 phases. The 64->2 encoder runs in f32
// with shuffles. (wgmma at N = 8 rows, 64 output columns per instruction, ran the same
// work slower than mma.sync on an H100.)
//
// Bound. At B = 1000 (cartpole) the forward does 0.375 GFLOP against ~0.5 MB of weights:
// 5.6 us with every FLOP at the f32 peak of 67 TFLOP/s; 2.3 us with every product at
// 495/3 TFLOP/s (split TF32) and the fourier combine at the f32 rate. The head's products
// (0.044 GFLOP) run in f32, a cost the kernel pays against the second bound. What holds the
// kernel back is latency, not rate: each CTA streams ~0.3 MB of weights from L2 into shared
// memory (the first 64 KB before any product can start), and the A + 1 GRU phases and 3
// further layers are dependent stages of short products with one CTA per SM.
//
// Numerics: accurate tanhf/sincosf/expf (no fast-math) and the per-hemisphere radius, since
// the ILT tail amplifies error near phi ~ pi/2 (pallas_nl.py:46-60).
//
// The streamed variant. The resident design holds every weight of a CTA in shared memory,
// which ends at H = 64 (8 warps of 8 GRU units a layer) and ~227 KB: at width 256 the weights
// alone take 1.04 MB, at 1024 14.4 MB. nl_forward_streamed_kernel keeps them in global memory
// (in the 50 MB L2 up to width 1024; at 2048 their 56 MB spill to HBM) and passes
// them through a ring of kStages shared-memory stages: a tile is the next few k-steps of a few
// column groups (GRU unit groups, trunk column tiles, head chunks) of one product, brought by
// cp.async.bulk copies completing on the stage's mbarrier; the warps run split-TF32 mma.sync
// (mma3) on the tile that has landed while the next ones stream in, and one thread refills a
// stage once every warp is done with it (__syncthreads). The buffer is the resident kernel's;
// the biases and the encoder are read from global memory. The activations stay in shared
// memory, unsplit (each warp splits its B fragments as it loads them): the action buffer, a
// rotation of three GRU states (layer 1 writes its new state where the old layer-2 state was),
// [obs; latent], the trunk's two layers, the head's per-term contributions. The GRU runs layer
// after layer, step after step (no wavefront); a warp owns one (column group, 8-row n-tile)
// pair of a tile, so its accumulators do not grow with the rows; the encoder gives each warp a
// row at a time; the head keeps f32 on the CUDA cores as in head_tile.
//
// Rows per CTA. Each CTA reads every weight once per GRU step: at width 512 (cartpole), 2.38 MB
// of GRU weights a step, 9.5 MB over A = 4, 11.0 MB with the trunk and the head. A CTA of R
// rows moves those bytes for 5.43 MFLOP a row, 0.49 R FLOP per byte of L2 traffic. At 8 rows
// (the resident kernel's) B = 20,000 would take 2,500 CTAs and 27 GB of L2 reads, ~5 ms at
// ~5.5 TB/s against 1.62 ms for the launch's FLOPs at the f32 rate (0.69 ms split TF32). So the
// rows per CTA are as many as shared memory holds, up to 64, with the trunk's two activations
// (2 R (hid + 4) floats) the largest part: R = 64 at width 256, 32 at 512, 16 at 1024, 8 at
// 2048. At 512 and B = 20,000 that is 625 CTAs and 6.9 GB, ~1.25 ms of L2 reads: below the
// f32-rate FLOP time, not below the split-TF32 one; a cluster multicasting each tile to its
// CTAs would divide the reads by its size (a later PR's work, as are wgmma and TMA
// descriptors). Where B / R would leave SMs idle (B = 1,000), R drops to the least that fits.
// The widest width the variant takes is where 8 rows of the trunk's activations and one tile
// of each product no longer fit: nl_hidden_units ~2,900 (forward_plan refuses wider).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;  // batch rows per CTA: the N side of mma.m16n8k8
constexpr int kWarps = 16;  // 8 for each GRU layer
constexpr int kThreads = 32 * kWarps;
static_assert(kWarps >= kRows, "the encoder gives a warp to each of the kRows rows");
constexpr int kGroup = 8;   // GRU hidden units per warp
constexpr int kHeadRows = 4;  // rows per thread in the head's f32 products
constexpr int kLatent = 2;  // action latent
constexpr int kBarFloats = 8;  // four mbarriers at the start of shared memory
// floats of one head chunk in shared memory (ops/pallas_ilt.py _HEAD_STAGE_FLOATS): 104
// columns at Hx = 128; a chunk takes as many columns as fit, at least 4
constexpr int kHeadStageFloats = 104 * (4 + 2 * 128);
constexpr int kSmemBudget = 232448;  // bytes: an H100 block's opt-in dynamic shared memory

constexpr double kPi = 3.14159265358979323846;
constexpr double kPhiMargin = 1e-4;  // ops/sphere.py _PHI_MARGIN
constexpr float kPiF = static_cast<float>(kPi);
constexpr float kHalfPiF = static_cast<float>(kPi / 2.0);
constexpr float kPhiLoF = static_cast<float>(-kPi / 2.0 + kPhiMargin);
constexpr float kPhiHiF = static_cast<float>(kPi / 2.0 - kPhiMargin);

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The head section of the weight buffer (ops/pallas_ilt.py repack_head): `chunks` chunks of
// mc columns, each b_theta, b_phi, c_re, c_im [mc] | W [Hx][mc][2] (theta, phi), Hx padded to a
// multiple of 4. The D*terms live columns are split evenly, mc a multiple of 4.
struct HeadDims {
  int Hx, D, terms, mc, chunks;
  __host__ __device__ int chunk() const { return mc * (4 + 2 * Hx); }
  __host__ __device__ int size() const { return chunks * chunk(); }
  __host__ __device__ int cols() const { return chunks * mc; }
};

HeadDims head_dims(int Hx, int D, int terms) {  // Hx: the padded width
  const int ncols = D * terms;
  int cap = kHeadStageFloats / (4 + 2 * Hx) / 4 * 4;
  if (cap < 4) cap = 4;
  const int chunks = (ncols + cap - 1) / cap;
  return HeadDims{Hx, D, terms, round_up((ncols + chunks - 1) / chunks, 4), chunks};
}

// Float offsets of the forward's buffer sections (ops/pallas_nl.py forward_sections) and of
// its shared-memory image.
struct ForwardLayout {
  int n, A, in_dim, H, hid;
  HeadDims head;
  int kx, k1;                       // padded widths of the GRU input and of [obs; latent]
  int small, gru1, gru2, w2;        // buffer sections before the head
  int ld_x, ld_h, ld_z, ld_hid, ld_c;  // activation row strides, 4 mod 32: no bank conflicts
  int region_a, region_b;           // gru1 then w2; gru2 then the head's chunks
  int o_a, o_b, o_xs, o_h, o_z, o_hid1, o_hid2, o_c, total;  // shared-memory offsets
};

ForwardLayout forward_layout(int n, int A, int in_dim, int H, int hid, int D, int terms) {
  ForwardLayout L;
  L.n = n; L.A = A; L.in_dim = in_dim; L.H = H; L.hid = hid;
  L.head = head_dims(hid, D, terms);
  L.kx = round_up(in_dim, 8);
  L.k1 = round_up(n + kLatent, 8);
  L.small = 12 * H + kLatent * H + 4 + L.k1 * hid + 2 * hid;
  L.gru1 = (H / kGroup) * (L.kx + H) * 24;
  L.gru2 = (H / kGroup) * 2 * H * 24;
  L.w2 = hid * hid;
  L.ld_x = L.kx + 4; L.ld_h = H + 4; L.ld_z = L.k1 + 4; L.ld_hid = hid + 4; L.ld_c = L.head.cols() + 4;
  L.region_a = L.gru1 > L.w2 ? L.gru1 : L.w2;
  L.region_b = L.gru2 > L.head.chunk() ? L.gru2 : L.head.chunk();
  L.o_a = kBarFloats + L.small;
  L.o_b = L.o_a + L.region_a;
  // the tensor cores' activations are stored split (2 kRows rows each); hid2 feeds the f32 head
  L.o_xs = L.o_b + L.region_b;
  L.o_h = L.o_xs + A * 2 * kRows * L.ld_x;  // h1 ping-pong, then h2 ping-pong
  L.o_z = L.o_h + 4 * 2 * kRows * L.ld_h;
  L.o_hid1 = L.o_z + 2 * kRows * L.ld_z;
  L.o_hid2 = L.o_hid1 + 2 * kRows * L.ld_hid;
  L.o_c = L.o_hid2 + kRows * L.ld_hid;
  L.total = L.o_c + kRows * L.ld_c;
  return L;
}

// ---- asynchronous copies and mbarriers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// Copies `bytes` (a multiple of 16) from global to shared memory; `bar` completes its phase
// when all have landed. One thread starts it.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits for the completion of `bar`'s phase of this parity (the first phase has parity 0).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity = 0) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// ---- split-TF32 tensor-core products ----

// x = hi + lo with hi the TF32 value nearest x and lo the TF32 value nearest x - hi (CUTLASS's
// 3xTF32 split; x - hi is exact in f32). What the pair leaves of x is below 2^-22 |x|, where
// one pass of TF32 errs by up to 2^-11 |x|. (Truncating hi, and the tensor core then reading
// lo truncated too, left up to 2^-20 |x|: 2.6 times the f32 forward's error on early weights.)
// to_tf32 rounds to nearest with ties away from zero in two integer operations: the bits of
// cvt.rna.tf32.f32 for every finite x, at the full ALU rate where the conversion takes a
// quarter (PERF.md, kernel table, times both).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// An activation that the tensor cores read is stored split once, by the thread that computes
// it, rather than by each of the warps that read it: X [kRows][ld] holds hi, X + kRows * ld lo.
__device__ __forceinline__ void put_split(float* X, int ld, int r, int k, float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  X[r * ld + k] = __uint_as_float(hi);
  X[(kRows + r) * ld + k] = __uint_as_float(lo);
}

__device__ __forceinline__ float get_split(const float* X, int ld, int r, int k) {
  return X[r * ld + k] + X[(kRows + r) * ld + k];  // hi + lo: v to within 2^-22 |v|
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16 x 8 output tile (16 weight columns by the CTA's 8 rows). Lane l holds register j at
// column m = l/4 + 8 (j/2) of the tile and batch row 2 (l%4) + j%2.
struct Acc {
  float hh[4], hl[4], lh[4];  // the three products, summed apart (three dependent chains)
  __device__ __forceinline__ Acc() {
#pragma unroll
    for (int j = 0; j < 4; ++j) hh[j] = hl[j] = lh[j] = 0.f;
  }
  __device__ __forceinline__ float get(int j) const { return hh[j] + (hl[j] + lh[j]); }
};

// The B operand: split activations X at columns k0..k0+7.
struct BFrag {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ BFrag load_b(const float* X, int ld, int k0, int lane) {
  const float* x = X + (lane >> 2) * ld + k0 + (lane & 3);
  const float* y = x + kRows * ld;
  return BFrag{{__float_as_uint(x[0]), __float_as_uint(x[4])},
               {__float_as_uint(y[0]), __float_as_uint(y[4])}};
}

__device__ __forceinline__ void mma3(Acc& acc, float a0, float a1, float a2, float a3,
                                     const BFrag& b) {
  uint32_t hi[4], lo[4];
  split(a0, hi[0], lo[0]);
  split(a1, hi[1], lo[1]);
  split(a2, hi[2], lo[2]);
  split(a3, hi[3], lo[3]);
  mma_tf32(acc.lh, lo, b.hi[0], b.hi[1]);
  mma_tf32(acc.hl, hi, b.lo[0], b.lo[1]);
  // The tensor core truncates when it adds to its accumulator, an error that grows with the
  // k-steps; the large product is formed apart and added in f32, rounded to nearest.
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc.hh[j] += t[j];
}

// acc += W^T X over `ksteps` steps of 8 for one tile, W in fragment order [ksteps][32][4].
__device__ __forceinline__ void tile_gemm(Acc& acc, const float* w, const float* X, int ld,
                                          int ksteps, int lane) {
  const float4* wf = reinterpret_cast<const float4*>(w) + lane;
#pragma unroll 4
  for (int kt = 0; kt < ksteps; ++kt) {
    const float4 a = wf[kt * 32];
    mma3(acc, a.x, a.y, a.z, a.w, load_b(X, ld, kt * 8, lane));
  }
}

// out[r][m] = tanh(acc + bias[m]) over tile mt, stored split when the tensor cores read it next.
template <bool kSplit>
__device__ __forceinline__ void store_tanh(const Acc& acc, const float* bias, float* out, int ld,
                                           int mt, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = mt * 16 + (lane >> 2) + 8 * (j >> 1);
    const int r = 2 * (lane & 3) + (j & 1);
    const float v = tanhf(acc.get(j) + bias[m]);
    if (kSplit) {
      put_split(out, ld, r, m, v);
    } else {
      out[r * ld + m] = v;
    }
  }
}

__device__ __forceinline__ float logisticf(float x) { return 1.f / (1.f + expf(-x)); }

// One GRU layer at one step for hidden units 8*group .. 8*group+7 (gates r/z/n,
// models/common.py gru_gates): h_out = (1 - z) n + z h_in, formed as n + z (h_in - n). x (split, row stride ldx) is the
// layer's input over kx steps of 8; h_in / h_out are split, row stride ldh. w holds the
// layer's tiles (per group: the r/z tile over [x; h], then the candidate's half tiles),
// bias = b_ih [3H] | b_hh [3H].
__device__ __forceinline__ void gru_group(const float* w, const float* bias, int H,
                                          const float* x, int ldx, int kx, const float* h_in,
                                          float* h_out, int ldh, int group, int lane) {
  const int kh = H / 8;
  const int ks = kx + kh;
  const float* w_rz = w + group * ks * 192;
  const float4* a_rz = reinterpret_cast<const float4*>(w_rz) + lane;
  const float2* a_n = reinterpret_cast<const float2*>(w_rz + ks * 128) + lane;
  Acc rz, nn;
#pragma unroll 2
  for (int kt = 0; kt < kx; ++kt) {  // input part: r/z, and the candidate's input half
    const BFrag b = load_b(x, ldx, kt * 8, lane);
    const float4 a = a_rz[kt * 32];
    mma3(rz, a.x, a.y, a.z, a.w, b);
    const float2 v = a_n[kt * 32];
    mma3(nn, v.x, 0.f, v.y, 0.f, b);
  }
#pragma unroll 4
  for (int kt = 0; kt < kh; ++kt) {  // hidden part: r/z, and the candidate's hidden half
    const BFrag b = load_b(h_in, ldh, kt * 8, lane);
    const float4 a = a_rz[(kx + kt) * 32];
    mma3(rz, a.x, a.y, a.z, a.w, b);
    const float2 v = a_n[(kx + kt) * 32];
    mma3(nn, 0.f, v.x, 0.f, v.y, b);
  }
  const int u = group * kGroup + (lane >> 2);
  const float* b_ih = bias;
  const float* b_hh = bias + 3 * H;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int row = 2 * (lane & 3) + q;
    const float r = logisticf(rz.get(q) + b_ih[u] + b_hh[u]);
    const float z = logisticf(rz.get(2 + q) + b_ih[H + u] + b_hh[H + u]);
    const float n = tanhf(nn.get(q) + b_ih[2 * H + u] + r * (nn.get(2 + q) + b_hh[2 * H + u]));
    put_split(h_out, ldh, row, u, fmaf(z, get_split(h_in, ldh, row, u) - n, n));  // n + z (h - n)
  }
}

// The head and the fourier combine for the kRows rows in x [kRows][ldx] (shared memory):
// theta = tanh(.) pi, phi = clip(tanh(.) pi/2), F = r e^{i theta} with the per-hemisphere
// radius, out[row0 + r, d] = sum_t Re(F w_t) for the live rows. The head's chunks (src, the
// repack_head buffer in global memory) pass through `region` in shared memory in turn,
// chunk c completing phase c of `bar`; the caller has issued chunk 0's copy. contrib is
// [kRows][cols + 4] scratch.
//
// Its two products run in f32 on the CUDA cores, not in split TF32: near the pole a head
// output moves by ~1e3 times its inputs' rounding, and split TF32 missed the 1e-3 limit on
// the head check on an H100. Each thread owns one column of both W_theta and W_phi
// for kHeadRows rows: one 8-byte weight load and one 16-byte activation load per row for
// every 4 steps of k, summed in k order as a sequential f32 dot product. (Splitting k between
// two lanes made it slower and less accurate.)
__device__ __forceinline__ void head_tile(const float* x, int ldx, const HeadDims& h,
                                          float* region, uint64_t* bar, const float* src,
                                          float* contrib, float* __restrict__ out, int row0,
                                          int B) {
  const int mc = h.mc;
  const int ncols = h.D * h.terms;
  const int ldc = h.cols() + 4;
  const float* b_theta = region;
  const float* b_phi = region + mc;
  const float* c_re = region + 2 * mc;
  const float* c_im = region + 3 * mc;
  const float2* w = reinterpret_cast<const float2*>(region + 4 * mc);  // [Hx][mc] (theta, phi)
  for (int c = 0; c < h.chunks; ++c) {
    mbar_wait(bar, c & 1);
    for (int idx = threadIdx.x; idx < (kRows / kHeadRows) * mc; idx += kThreads) {
      const int m = idx % mc;
      const int r0 = (idx / mc) * kHeadRows;
      float at[kHeadRows] = {};
      float ap[kHeadRows] = {};
      for (int k = 0; k < h.Hx; k += 4) {
        float xq[kHeadRows][4];
#pragma unroll
        for (int q = 0; q < kHeadRows; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(x + (r0 + q) * ldx + k);
          xq[q][0] = v.x; xq[q][1] = v.y; xq[q][2] = v.z; xq[q][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float2 wv = w[(k + kk) * mc + m];
#pragma unroll
          for (int q = 0; q < kHeadRows; ++q) {
            at[q] = fmaf(xq[q][kk], wv.x, at[q]);
            ap[q] = fmaf(xq[q][kk], wv.y, ap[q]);
          }
        }
      }
      const int col = c * mc + m;
      if (col >= ncols) continue;
#pragma unroll
      for (int q = 0; q < kHeadRows; ++q) {
        const float theta = tanhf(at[q] + b_theta[m]) * kPiF;
        const float phi = fminf(fmaxf(tanhf(ap[q] + b_phi[m]) * kHalfPiF, kPhiLoF), kPhiHiF);
        float sin_phi, cos_phi, sin_theta, cos_theta;
        sincosf(phi, &sin_phi, &cos_phi);
        sincosf(theta, &sin_theta, &cos_theta);
        const float radius = phi >= 0.f ? (1.f + sin_phi) / cos_phi : cos_phi / (1.f - sin_phi);
        contrib[(r0 + q) * ldc + col] = radius * cos_theta * c_re[m] - radius * sin_theta * c_im[m];
      }
    }
    __syncthreads();
    if (c + 1 < h.chunks && threadIdx.x == 0) {  // every thread is done with chunk c
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk_load(region, src + (c + 1) * h.chunk(), 4u * h.chunk(), bar);
    }
  }
  for (int idx = threadIdx.x; idx < kRows * h.D; idx += kThreads) {
    const int r = idx / h.D;
    const int d = idx % h.D;
    if (row0 + r >= B) continue;
    const float* c = contrib + r * ldc + d * h.terms;
    float acc = 0.f;
#pragma unroll 4
    for (int t = 0; t < h.terms; ++t) acc += c[t];
    out[(row0 + r) * h.D + d] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
nl_forward_kernel(const float* __restrict__ obs, const float* __restrict__ acts,
                  const float* __restrict__ buf, float* __restrict__ out, int B,
                  ForwardLayout L) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* s_small = smem + kBarFloats;
  float* s_a = smem + L.o_a;
  float* s_b = smem + L.o_b;
  float* xs = smem + L.o_xs;
  // GRU states: h1 ping-pong at h + {0, 1} * hb, h2 ping-pong at h + {2, 3} * hb (pointer
  // arithmetic on smem, not a pointer array, keeps the loads in the shared address space)
  float* h = smem + L.o_h;
  const int hb = 2 * kRows * L.ld_h;
  float* z1 = smem + L.o_z;
  float* hid1 = smem + L.o_hid1;
  float* hid2 = smem + L.o_hid2;
  const int H = L.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * kRows;

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_load(s_small, buf, 4u * (L.small + L.gru1), bars + 0);  // small + GRU layer 1
    bulk_load(s_b, buf + L.small + L.gru1, 4u * L.gru2, bars + 1);  // GRU layer 2
  }
  // one pass over the inputs, so that each thread waits on one global load: the action buffer
  // as A steps of [kRows][kx], zero-padded; [obs | latent | 0]; h = 0
  const int A_in = L.A * L.in_dim;
  const int n_xs = L.A * kRows * L.kx;
  const int n_z = kRows * L.k1;
  for (int idx = tid; idx < n_xs + n_z + kRows * H; idx += kThreads) {
    if (idx < n_xs) {
      const int k = idx % L.kx;
      const int r = (idx / L.kx) % kRows;
      const int s = idx / (L.kx * kRows);
      const bool live = k < L.in_dim && row0 + r < B;
      put_split(xs + s * 2 * kRows * L.ld_x, L.ld_x, r, k,
                live ? acts[(row0 + r) * A_in + s * L.in_dim + k] : 0.f);
    } else if (idx < n_xs + n_z) {
      const int r = (idx - n_xs) / L.k1;
      const int k = (idx - n_xs) % L.k1;
      put_split(z1, L.ld_z, r, k, (k < L.n && row0 + r < B) ? obs[(row0 + r) * L.n + k] : 0.f);
    } else {
      const int r = (idx - n_xs - n_z) / H;
      const int k = (idx - n_xs - n_z) % H;
      put_split(h, L.ld_h, r, k, 0.f);
      put_split(h + 2 * hb, L.ld_h, r, k, 0.f);
    }
  }
  __syncthreads();

  // GRU wavefront: phase p runs layer 1 at step p and layer 2 at step p - 1, newest action
  // first (w_nl.py:27). h1 buffer p % 2 holds layer 1's state after step p - 1.
  mbar_wait(bars + 0);
  for (int p = 0; p <= L.A; ++p) {
    if (p == 1) mbar_wait(bars + 1);
    if (p == L.A && tid == 0) {  // layer 1 is done with region A: bring the trunk's w2
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk_load(s_a, buf + L.small + L.gru1 + L.gru2, 4u * L.w2, bars + 2);
    }
    const int group = warp % (kWarps / 2);
    if (group < H / kGroup) {
      if (warp < kWarps / 2 && p < L.A) {
        const float* x = xs + (L.A - 1 - p) * 2 * kRows * L.ld_x;
        gru_group(s_a, s_small, H, x, L.ld_x, L.kx / 8, h + (p & 1) * hb, h + ((p + 1) & 1) * hb,
                  L.ld_h, group, lane);
      }
      if (warp >= kWarps / 2 && p >= 1) {
        gru_group(s_b, s_small + 6 * H, H, h + (p & 1) * hb, L.ld_h, H / 8,
                  h + (2 + ((p - 1) & 1)) * hb, h + (2 + (p & 1)) * hb, L.ld_h, group, lane);
      }
    }
    __syncthreads();
  }
  const float* head_src = buf + L.small + L.gru1 + L.gru2 + L.w2;
  if (tid == 0) {  // the GRU is done with region B: bring the head's first chunk
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bulk_load(s_b, head_src, 4u * L.head.chunk(), bars + 3);
  }

  // encoder head H -> 2 in f32 on the CUDA cores: warp r < kRows owns batch row r, its lanes
  // split k into 16 parts for each of the 2 columns and meet by shuffles
  const float* w_enc = s_small + 12 * H;
  if (warp < kRows) {
    const float* h2 = h + (2 + (L.A & 1)) * hb;
    const int col = lane & 1;
    float v = 0.f;
    for (int k = lane >> 1; k < H; k += 16) {
      v = fmaf(get_split(h2, L.ld_h, warp, k), w_enc[k * kLatent + col], v);
    }
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane < kLatent) put_split(z1, L.ld_z, warp, L.n + col, v + w_enc[kLatent * H + col]);
  }
  __syncthreads();

  // trunk layer 1 over [obs; latent] (normalization and contour folded in), then layer 2
  const float* w1 = w_enc + kLatent * H + 4;
  const float* b1 = w1 + L.k1 * L.hid;
  const float* b2 = b1 + L.hid;
  for (int mt = warp; mt < L.hid / 16; mt += kWarps) {
    Acc acc;
    tile_gemm(acc, w1 + mt * (L.k1 / 8) * 128, z1, L.ld_z, L.k1 / 8, lane);
    store_tanh<true>(acc, b1, hid1, L.ld_hid, mt, lane);
  }
  __syncthreads();
  mbar_wait(bars + 2);
  for (int mt = warp; mt < L.hid / 16; mt += kWarps) {
    Acc acc;
    tile_gemm(acc, s_a + mt * (L.hid / 8) * 128, hid1, L.ld_hid, L.hid / 8, lane);
    store_tanh<false>(acc, b2, hid2, L.ld_hid, mt, lane);
  }
  __syncthreads();
  head_tile(hid2, L.ld_hid, L.head, s_b, bars + 3, head_src, smem + L.o_c, out, row0, B);
}

__global__ void __launch_bounds__(kThreads)
nl_head_kernel(const float* __restrict__ x, const float* __restrict__ buf,
               float* __restrict__ out, int B, int hx_in, HeadDims h) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_head = smem + kBarFloats;
  float* s_x = s_head + h.chunk();
  const int ldx = h.Hx + 4;
  float* contrib = s_x + kRows * ldx;
  const int row0 = blockIdx.x * kRows;
  if (threadIdx.x == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_load(s_head, buf, 4u * h.chunk(), bar);
  }
  for (int idx = threadIdx.x; idx < kRows * h.Hx; idx += kThreads) {  // x [B, hx_in], zero-padded
    const int r = idx / h.Hx;
    const int k = idx % h.Hx;
    s_x[r * ldx + k] = row0 + r < B && k < hx_in ? x[(row0 + r) * hx_in + k] : 0.f;
  }
  __syncthreads();
  head_tile(s_x, ldx, h, s_head, bar, buf, contrib, out, row0, B);
}

// ---- the weight-streaming forward ----

constexpr int kStages = 3;             // shared-memory stages of the weight ring
static_assert(kStages * 2 <= kBarFloats, "the ring's mbarriers sit in the first kBarFloats floats");
constexpr int kMaxStageFloats = 8192;  // 32 KB a stage at most
constexpr int kTargetCtas = 132;       // an H100 SXM's SMs: rows per CTA shrink to fill them
constexpr int kStreamRows[4] = {64, 32, 16, 8};

// One product of the forward as the streamed kernel walks it: `groups` column groups of the
// weight buffer, each one or two contiguous runs of [ks][kf] floats (part 1 at `part1` within
// the group). A tile is the next kc k-steps of gs groups (a panel); each panel is walked
// `repeat` times. In a stage, group i of the tile lies at i kc (kf0 + kf1), its part 1 kc kf0
// further.
struct StreamGemm {
  int src, group_stride, part1, kf0, kf1, ks, kc, groups, gs, repeat;
  __host__ __device__ int chunks() const { return (ks + kc - 1) / kc; }
  __host__ __device__ int panels() const { return (groups + gs - 1) / gs * repeat; }
  __host__ __device__ int tiles() const { return panels() * chunks(); }
  __host__ __device__ int group_floats() const { return kc * (kf0 + kf1); }
};

enum { kGru1, kGru2, kTrunk1, kTrunk2, kHead, kGemms };

struct StreamLayout {
  int n, A, in_dim, H, hid, rows;       // H and hid padded
  HeadDims head;
  int kx, k1, ldx, ldh, ldz, ldhid, ldc;
  int b_gru2, o_wenc, o_benc, o_b1, o_b2, o_head;  // float offsets in the buffer
  int passes;                           // head passes over a chunk's (column, 4-row) pairs
  StreamGemm g[kGemms];
  int stage, total_tiles;
  int o_stage, o_z, o_act, total;       // shared-memory offsets (floats)
};

// The streamed layout for `rows` rows a CTA, or false if it does not fit in shared memory.
bool stream_layout(const ForwardLayout& F, int rows, StreamLayout& S) {
  const int H = F.H, hid = F.hid;
  const int nt = rows / kRows;
  const int gs = kWarps / nt;  // a warp per (group, n-tile) pair
  S.n = F.n; S.A = F.A; S.in_dim = F.in_dim; S.H = H; S.hid = hid; S.rows = rows;
  S.head = F.head;
  S.kx = F.kx; S.k1 = F.k1;
  S.ldx = F.kx + 4; S.ldh = H + 4; S.ldz = F.k1 + 4; S.ldhid = hid + 4; S.ldc = F.head.cols() + 4;
  const int o_w1 = 14 * H + 4;
  S.b_gru2 = 6 * H; S.o_wenc = 12 * H; S.o_benc = 14 * H;
  S.o_b1 = o_w1 + F.k1 * hid; S.o_b2 = S.o_b1 + hid;
  S.o_head = F.small + F.gru1 + F.gru2 + F.w2;
  const int mc = F.head.mc;
  S.passes = (mc * (rows / kHeadRows) + kThreads - 1) / kThreads;
  const int ks1 = F.kx / 8 + H / 8, ks2 = 2 * H / 8;
  S.g[kGru1] = StreamGemm{F.small, ks1 * 192, ks1 * 128, 128, 64, ks1, 0, H / kGroup, gs, 1};
  S.g[kGru2] = StreamGemm{F.small + F.gru1, ks2 * 192, ks2 * 128, 128, 64, ks2, 0, H / kGroup, gs, 1};
  S.g[kTrunk1] = StreamGemm{o_w1, F.k1 / 8 * 128, 0, 128, 0, F.k1 / 8, 0, hid / 16, gs, 1};
  S.g[kTrunk2] = StreamGemm{F.small + F.gru1 + F.gru2, hid / 8 * 128, 0, 128, 0, hid / 8, 0, hid / 16, gs, 1};
  S.g[kHead] = StreamGemm{S.o_head + 4 * mc, F.head.chunk(), 0, 2 * mc, 0, F.head.Hx, 0,
                          F.head.chunks, 1, S.passes};
  const int z = rows * S.ldz;
  const int gru_act = F.A * rows * S.ldx + 3 * rows * S.ldh;
  const int trunk_act = 2 * rows * S.ldhid + rows * S.ldc;
  const int act = gru_act > trunk_act ? gru_act : trunk_act;
  const long long avail = kSmemBudget / 4 - kBarFloats - z - act;
  if (avail <= 0) return false;
  int budget = static_cast<int>(avail / kStages);
  if (budget > kMaxStageFloats) budget = kMaxStageFloats;
  S.stage = 0;
  for (int i = 0; i < kGemms; ++i) {
    StreamGemm& G = S.g[i];
    const int per_k = G.gs * (G.kf0 + G.kf1);
    int kc = budget / per_k;
    if (i == kHead) kc = kc / kHeadRows * kHeadRows;  // the head reads 4 rows of k at a time
    if (kc > G.ks) kc = G.ks;
    if (kc < (i == kHead ? kHeadRows : 1)) return false;
    G.kc = kc;
    if (G.gs * G.group_floats() > S.stage) S.stage = G.gs * G.group_floats();
  }
  S.total_tiles = F.A * (S.g[kGru1].tiles() + S.g[kGru2].tiles()) + S.g[kTrunk1].tiles() +
                  S.g[kTrunk2].tiles() + S.g[kHead].tiles();
  S.o_stage = kBarFloats;
  S.o_z = S.o_stage + kStages * S.stage;
  S.o_act = S.o_z + z;
  S.total = S.o_act + act;
  return true;
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Starts the copies of tile t of the whole forward (in the order the kernel consumes them:
// per GRU step layer 1 then layer 2, then the trunk's two layers, then the head) into `dst`,
// completing on `bar`. One thread calls it.
__device__ void stream_issue(const StreamLayout& L, const float* buf, int t, float* dst,
                             uint64_t* bar) {
  const int per_step = L.g[kGru1].tiles() + L.g[kGru2].tiles();
  int i;
  if (t < L.A * per_step) {
    t %= per_step;
    i = t < L.g[kGru1].tiles() ? kGru1 : kGru2;
    if (i == kGru2) t -= L.g[kGru1].tiles();
  } else {
    t -= L.A * per_step;
    i = kTrunk1;
    while (t >= L.g[i].tiles()) t -= L.g[i++].tiles();
  }
  const StreamGemm& G = L.g[i];
  const int chunks = G.chunks();
  const int panel = t / chunks;
  const int k0 = (t % chunks) * G.kc;
  const int kn = min(G.kc, G.ks - k0);
  const int g0 = panel / G.repeat * G.gs;
  const int ng = min(G.gs, G.groups - g0);
  mbar_expect(bar, 4u * ng * kn * (G.kf0 + G.kf1));
  for (int j = 0; j < ng; ++j) {
    const float* src = buf + G.src + (g0 + j) * G.group_stride;
    float* d = dst + j * G.group_floats();
    bulk_copy(d, src + k0 * G.kf0, 4u * kn * G.kf0, bar);
    if (G.kf1) bulk_copy(d + G.kc * G.kf0, src + G.part1 + k0 * G.kf1, 4u * kn * G.kf1, bar);
  }
}

// The ring of weight stages. Every thread walks the same tiles in the same order: acquire()
// waits for the next tile, release() frees its stage once every thread is done with it and
// refills it with the tile kStages further on.
struct Ring {
  const StreamLayout* L;
  const float* buf;
  float* stages;
  uint64_t* bars;
  int next;
  __device__ const float* acquire() const {
    const int s = next % kStages;
    mbar_wait(bars + s, (next / kStages) & 1);
    return stages + s * L->stage;
  }
  __device__ void release() {
    __syncthreads();
    const int s = next % kStages;
    if (threadIdx.x == 0 && next + kStages < L->total_tiles) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      stream_issue(*L, buf, next + kStages, stages + s * L->stage, bars + s);
    }
    ++next;
  }
};

// The B operand from unsplit activations X (row stride ld) at columns k0..k0+7, split here.
__device__ __forceinline__ BFrag load_b_split(const float* X, int ld, int k0, int lane) {
  const float* x = X + (lane >> 2) * ld + k0 + (lane & 3);
  BFrag b;
  split(x[0], b.hi[0], b.lo[0]);
  split(x[4], b.hi[1], b.lo[1]);
  return b;
}

// One GRU layer at one step over the CTA's rows: x (kxs k-steps, row stride ldx) and h_in ->
// h_out, all unsplit with row stride ldh for the states; bias = b_ih [3H] | b_hh [3H] in global
// memory. Warp w owns unit group (panel gs + w % gs) for n-tile w / gs.
__device__ void stream_gru(Ring& ring, const StreamGemm& G, const float* __restrict__ bias, int H,
                           const float* x, int ldx, int kxs, const float* h_in, float* h_out,
                           int ldh, int warp, int lane) {
  const int slot = warp % G.gs;
  const int r0 = warp / G.gs * kRows;
  const float* xr = x + r0 * ldx;
  const float* hr = h_in + r0 * ldh;
  for (int p = 0; p < G.panels(); ++p) {
    const int group = p * G.gs + slot;
    Acc rz, nn;
    for (int c = 0; c < G.chunks(); ++c) {
      const float* st = ring.acquire();
      if (group < G.groups) {
        const int k0 = c * G.kc;
        const int kn = min(G.kc, G.ks - k0);
        const float4* a_rz = reinterpret_cast<const float4*>(st + slot * G.group_floats()) + lane;
        const float2* a_n =
            reinterpret_cast<const float2*>(st + slot * G.group_floats() + G.kc * 128) + lane;
        for (int i = 0; i < kn; ++i) {
          const int kt = k0 + i;
          const bool in_x = kt < kxs;
          const BFrag b = in_x ? load_b_split(xr, ldx, kt * 8, lane)
                               : load_b_split(hr, ldh, (kt - kxs) * 8, lane);
          const float4 a = a_rz[i * 32];
          mma3(rz, a.x, a.y, a.z, a.w, b);
          const float2 v = a_n[i * 32];
          if (in_x) {
            mma3(nn, v.x, 0.f, v.y, 0.f, b);
          } else {
            mma3(nn, 0.f, v.x, 0.f, v.y, b);
          }
        }
      }
      ring.release();
    }
    if (group < G.groups) {
      const int u = group * kGroup + (lane >> 2);
      const float* b_ih = bias;
      const float* b_hh = bias + 3 * H;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = r0 + 2 * (lane & 3) + q;
        const float r = logisticf(rz.get(q) + __ldg(b_ih + u) + __ldg(b_hh + u));
        const float z = logisticf(rz.get(2 + q) + __ldg(b_ih + H + u) + __ldg(b_hh + H + u));
        const float n = tanhf(nn.get(q) + __ldg(b_ih + 2 * H + u) +
                              r * (nn.get(2 + q) + __ldg(b_hh + 2 * H + u)));
        h_out[row * ldh + u] = fmaf(z, h_in[row * ldh + u] - n, n);  // n + z (h - n)
      }
    }
  }
  __syncthreads();  // the next product reads h_out
}

// out = tanh(x W + b) over the CTA's rows, W streamed in column tiles of 16; b in global memory.
__device__ void stream_dense(Ring& ring, const StreamGemm& G, const float* __restrict__ bias,
                             const float* x, int ldx, float* out, int ldo, int warp, int lane) {
  const int slot = warp % G.gs;
  const int r0 = warp / G.gs * kRows;
  const float* xr = x + r0 * ldx;
  for (int p = 0; p < G.panels(); ++p) {
    const int mt = p * G.gs + slot;
    Acc acc;
    for (int c = 0; c < G.chunks(); ++c) {
      const float* st = ring.acquire();
      if (mt < G.groups) {
        const int k0 = c * G.kc;
        const int kn = min(G.kc, G.ks - k0);
        const float4* wf = reinterpret_cast<const float4*>(st + slot * G.group_floats()) + lane;
        for (int i = 0; i < kn; ++i) {
          const float4 a = wf[i * 32];
          mma3(acc, a.x, a.y, a.z, a.w, load_b_split(xr, ldx, (k0 + i) * 8, lane));
        }
      }
      ring.release();
    }
    if (mt < G.groups) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = mt * 16 + (lane >> 2) + 8 * (j >> 1);
        const int r = r0 + 2 * (lane & 3) + (j & 1);
        out[r * ldo + m] = tanhf(acc.get(j) + __ldg(bias + m));
      }
    }
  }
  __syncthreads();
}

// The head over the CTA's rows, as head_tile computes it for 8: x [rows][ldx] (hid2) -> the
// per-term contributions in contrib, then out. Each (column, 4-row) pair of a chunk is one
// thread's in one of L.passes passes, its weights streamed k-tile by k-tile.
__device__ void stream_head(Ring& ring, const StreamLayout& L, const float* __restrict__ buf,
                            const float* x, float* contrib, float* __restrict__ out, int row0,
                            int B) {
  const HeadDims& h = L.head;
  const StreamGemm& G = L.g[kHead];
  const int mc = h.mc;
  const int ncols = h.D * h.terms;
  const int ldx = L.ldhid;
  const int pairs = mc * (L.rows / kHeadRows);
  for (int c = 0; c < h.chunks; ++c) {
    const float* vec = buf + L.o_head + c * h.chunk();  // b_theta, b_phi, c_re, c_im [mc]
    for (int pass = 0; pass < L.passes; ++pass) {
      const int idx = pass * kThreads + threadIdx.x;
      const bool live = idx < pairs;
      const int m = idx % mc;
      const int r0 = idx / mc * kHeadRows;
      float at[kHeadRows] = {};
      float ap[kHeadRows] = {};
      for (int kc = 0; kc < G.chunks(); ++kc) {
        const float* st = ring.acquire();
        if (live) {
          const int k0 = kc * G.kc;
          const int kn = min(G.kc, G.ks - k0);
          const float2* w = reinterpret_cast<const float2*>(st);  // [kn][mc] (theta, phi)
          for (int k = 0; k < kn; k += 4) {
            float xq[kHeadRows][4];
#pragma unroll
            for (int q = 0; q < kHeadRows; ++q) {
              const float4 v = *reinterpret_cast<const float4*>(x + (r0 + q) * ldx + k0 + k);
              xq[q][0] = v.x; xq[q][1] = v.y; xq[q][2] = v.z; xq[q][3] = v.w;
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float2 wv = w[(k + kk) * mc + m];
#pragma unroll
              for (int q = 0; q < kHeadRows; ++q) {
                at[q] = fmaf(xq[q][kk], wv.x, at[q]);
                ap[q] = fmaf(xq[q][kk], wv.y, ap[q]);
              }
            }
          }
        }
        ring.release();
      }
      const int col = c * mc + m;
      if (!live || col >= ncols) continue;
      const float bt = __ldg(vec + m), bp = __ldg(vec + mc + m);
      const float cre = __ldg(vec + 2 * mc + m), cim = __ldg(vec + 3 * mc + m);
#pragma unroll
      for (int q = 0; q < kHeadRows; ++q) {
        const float theta = tanhf(at[q] + bt) * kPiF;
        const float phi = fminf(fmaxf(tanhf(ap[q] + bp) * kHalfPiF, kPhiLoF), kPhiHiF);
        float sin_phi, cos_phi, sin_theta, cos_theta;
        sincosf(phi, &sin_phi, &cos_phi);
        sincosf(theta, &sin_theta, &cos_theta);
        const float radius = phi >= 0.f ? (1.f + sin_phi) / cos_phi : cos_phi / (1.f - sin_phi);
        contrib[(r0 + q) * L.ldc + col] = radius * cos_theta * cre - radius * sin_theta * cim;
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < L.rows * h.D; idx += kThreads) {
    const int r = idx / h.D;
    const int d = idx % h.D;
    if (row0 + r >= B) continue;
    const float* cr = contrib + r * L.ldc + d * h.terms;
    float acc = 0.f;
    for (int t = 0; t < h.terms; ++t) acc += cr[t];
    out[(row0 + r) * h.D + d] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
nl_forward_streamed_kernel(const float* __restrict__ obs, const float* __restrict__ acts,
                           const float* __restrict__ buf, float* __restrict__ out, int B,
                           const __grid_constant__ StreamLayout L) {
  extern __shared__ __align__(16) float smem[];
  const int R = L.rows;
  const int H = L.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * R;
  Ring ring{&L, buf, smem + L.o_stage, reinterpret_cast<uint64_t*>(smem), 0};
  float* z1 = smem + L.o_z;
  float* xs = smem + L.o_act;  // A steps of [R][ldx]
  float* hs = xs + L.A * R * L.ldx;  // three GRU states of [R][ldh]
  const int hb = R * L.ldh;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(ring.bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int t = 0; t < kStages && t < L.total_tiles; ++t) {
      stream_issue(L, buf, t, ring.stages + t * L.stage, ring.bars + t);
    }
  }
  const int A_in = L.A * L.in_dim;
  const int n_xs = L.A * R * L.kx;
  const int n_z = R * L.k1;
  for (int idx = tid; idx < n_xs + n_z + 2 * R * H; idx += kThreads) {
    if (idx < n_xs) {
      const int k = idx % L.kx;
      const int r = (idx / L.kx) % R;
      const int s = idx / (L.kx * R);
      const bool live = k < L.in_dim && row0 + r < B;
      xs[(s * R + r) * L.ldx + k] = live ? acts[(row0 + r) * A_in + s * L.in_dim + k] : 0.f;
    } else if (idx < n_xs + n_z) {
      const int r = (idx - n_xs) / L.k1;
      const int k = (idx - n_xs) % L.k1;
      z1[r * L.ldz + k] = (k < L.n && row0 + r < B) ? obs[(row0 + r) * L.n + k] : 0.f;
    } else {  // h1 and h2 start at zero (states 0 and 1)
      const int i = idx - n_xs - n_z;
      hs[(i / (R * H)) * hb + (i % (R * H)) / H * L.ldh + i % H] = 0.f;
    }
  }
  __syncthreads();

  // newest action first (w_nl.py:27); each layer writes its new state over the free one
  int h1 = 0, h2 = 1, spare = 2;
  for (int s = 0; s < L.A; ++s) {
    stream_gru(ring, L.g[kGru1], buf, H, xs + (L.A - 1 - s) * R * L.ldx, L.ldx, L.kx / 8,
               hs + h1 * hb, hs + spare * hb, L.ldh, warp, lane);
    int t = h1; h1 = spare; spare = t;
    stream_gru(ring, L.g[kGru2], buf + L.b_gru2, H, hs + h1 * hb, L.ldh, H / 8, hs + h2 * hb,
               hs + spare * hb, L.ldh, warp, lane);
    t = h2; h2 = spare; spare = t;
  }

  // encoder H -> 2 in f32: a warp a row, its lanes split k into 16 parts for each column
  const float* h2s = hs + h2 * hb;
  for (int r = warp; r < R; r += kWarps) {
    const int col = lane & 1;
    float v = 0.f;
    for (int k = lane >> 1; k < H; k += 16) {
      v = fmaf(h2s[r * L.ldh + k], __ldg(buf + L.o_wenc + k * kLatent + col), v);
    }
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane < kLatent) z1[r * L.ldz + L.n + col] = v + __ldg(buf + L.o_benc + col);
  }
  __syncthreads();

  float* hid1 = smem + L.o_act;  // over the GRU's activations, done with
  float* hid2 = hid1 + R * L.ldhid;
  stream_dense(ring, L.g[kTrunk1], buf + L.o_b1, z1, L.ldz, hid1, L.ldhid, warp, lane);
  stream_dense(ring, L.g[kTrunk2], buf + L.o_b2, hid1, L.ldhid, hid2, L.ldhid, warp, lane);
  stream_head(ring, L, buf, hid2, hid2 + R * L.ldhid, out, row0, B);
}

int g_smem_limit = 0;  // bytes of dynamic shared memory a block may use, set by nl_init

int grid_for(int B, int rows) { return (B + rows - 1) / rows; }

enum { kResident = 0, kStreamed = 1, kBadDims = -1, kTooWide = -2 };

// dims of a forward launch: B, n, A, in_dim, H, hid, D, terms, buf_len (floats), with H and
// hid the model's widths. Returns the variant (kResident where every weight fits in shared
// memory with H <= 64, the resident kernel's layout, else kStreamed) and fills its layout, or
// kBadDims / kTooWide.
int forward_plan(const int* dims, int n_dims, ForwardLayout& L, StreamLayout& S) {
  if (n_dims != 9) return kBadDims;
  const int B = dims[0], n = dims[1], A = dims[2], in_dim = dims[3];
  const int H = round_up(dims[4], kGroup), hid = round_up(dims[5], 16);
  const int D = dims[6], terms = dims[7], buf_len = dims[8];
  if (B < 0 || n <= 0 || A <= 0 || in_dim <= 0 || H <= 0 || hid <= 0 || D <= 0 || terms <= 0) {
    return kBadDims;
  }
  L = forward_layout(n, A, in_dim, H, hid, D, terms);
  if (L.small + L.gru1 + L.gru2 + L.w2 + L.head.size() != buf_len) return kBadDims;  // another layout
  if (H / kGroup <= kWarps / 2 && 4LL * L.total <= kSmemBudget) return kResident;
  // the most rows that fit while B / rows fills the SMs, else the fewest that fit
  bool fits = false;
  for (int rows : kStreamRows) {  // most first
    StreamLayout T;
    if (!stream_layout(L, rows, T)) continue;
    S = T;
    fits = true;
    if (grid_for(B, rows) >= kTargetCtas) break;
  }
  return fits ? kStreamed : kTooWide;
}

long long plan_smem(int variant, const ForwardLayout& L, const StreamLayout& S) {
  if (variant == kResident) return 4LL * L.total;
  if (variant == kStreamed) return 4LL * S.total;
  return -1;
}

// dims of a head launch: B, Hx, D, terms, buf_len (floats), Hx the input's width.
long long head_plan(const int* dims, int n_dims, HeadDims& h) {
  if (n_dims != 5) return -1;
  if (dims[0] < 0 || dims[1] <= 0 || dims[2] <= 0 || dims[3] <= 0) return -1;
  h = head_dims(round_up(dims[1], 4), dims[2], dims[3]);
  if (h.size() != dims[4]) return -1;  // another layout
  return 4LL * (kBarFloats + h.chunk() + kRows * (h.Hx + 4) + kRows * (h.cols() + 4));
}

int check_smem(long long smem) {
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (g_smem_limit == 0) return static_cast<int>(cudaErrorInitializationError);
  if (smem > g_smem_limit) return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

}  // namespace

extern "C" {

// Lets the kernels use the device's whole opt-in shared memory. Call once per device, after
// the library loads, with that device current; returns a cudaError_t (0 on success).
int nl_init() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&g_smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  const void* kernels[] = {reinterpret_cast<const void*>(nl_forward_kernel),
                           reinterpret_cast<const void*>(nl_forward_streamed_kernel),
                           reinterpret_cast<const void*>(nl_head_kernel)};
  for (const void* k : kernels) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, g_smem_limit);
    }
  }
  return static_cast<int>(err);
}

// The variant a forward launch with these dims runs: 0 resident, 1 streamed (and its batch
// rows per CTA in *rows), -1 for malformed dims or a buffer of another length, -2 for widths
// that neither variant's shared memory holds.
int nl_forward_variant(const int* dims, int n_dims, int* rows) {
  ForwardLayout L;
  StreamLayout S;
  const int v = forward_plan(dims, n_dims, L, S);
  *rows = v == kResident ? kRows : v == kStreamed ? S.rows : 0;
  return v;
}

// The dynamic shared memory, in bytes, of a launch with these dims (as the launchers take
// them), or -1 if the launcher refuses them.
long long nl_forward_smem_bytes(const int* dims, int n_dims) {
  ForwardLayout L;
  StreamLayout S;
  return plan_smem(forward_plan(dims, n_dims, L, S), L, S);
}

long long nl_head_smem_bytes(const int* dims, int n_dims) {
  HeadDims h;
  return head_plan(dims, n_dims, h);
}

// ptrs: obs [B, n], acts [B, A*in_dim], buf (repack_nl_forward), out [B, D].
// dims: B, n, A, in_dim, H, hid, D, terms, buf_len (floats).
// Launches the variant forward_plan picks on `stream`; returns the cudaError_t of the launch
// (0 on success).
int nl_forward_launch(const void* const* ptrs, int n_ptrs, const int* dims, int n_dims,
                      void* stream) {
  ForwardLayout L;
  StreamLayout S;
  const int variant = forward_plan(dims, n_dims, L, S);
  if (n_ptrs != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = check_smem(plan_smem(variant, L, S))) return err;
  const int B = dims[0];
  if (B == 0) return 0;
  const float* const* p = reinterpret_cast<const float* const*>(ptrs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kResident) {
    nl_forward_kernel<<<grid_for(B, kRows), kThreads, 4LL * L.total, st>>>(
        p[0], p[1], p[2], const_cast<float*>(p[3]), B, L);
  } else {
    nl_forward_streamed_kernel<<<grid_for(B, S.rows), kThreads, 4LL * S.total, st>>>(
        p[0], p[1], p[2], const_cast<float*>(p[3]), B, S);
  }
  return static_cast<int>(cudaGetLastError());
}

// ptrs: x [B, Hx], buf (repack_head), out [B, D].
// dims: B, Hx, D, terms, buf_len (floats).
int nl_head_launch(const void* const* ptrs, int n_ptrs, const int* dims, int n_dims,
                   void* stream) {
  HeadDims h;
  const long long smem = head_plan(dims, n_dims, h);
  if (n_ptrs != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = check_smem(smem)) return err;
  const int B = dims[0];
  if (B == 0) return 0;
  const float* const* p = reinterpret_cast<const float* const*>(ptrs);
  nl_head_kernel<<<grid_for(B, kRows), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p[0], p[1], const_cast<float*>(p[2]), B, dims[1], h);
  return static_cast<int>(cudaGetLastError());
}

const char* nl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
