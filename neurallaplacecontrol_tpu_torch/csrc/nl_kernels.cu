// Hand-written CUDA kernels for the planner-path Neural Laplace forward (sm_90a).
//
// nl_forward_kernel replaces neurallaplacecontrol_tpu/ops/pallas_nl.py::_nl_forward_kernel:
// raw obs [B, n] and the raw flattened action buffer [B, A*in] -> state difference [B, D].
// It runs a 2-layer GRU over the buffer newest to oldest, the encoder head, the two tanh
// trunk layers and the theta/phi head with the fourier ILT combine.
//
// Past width 128, and wherever its weights and activations do not fit in shared memory (a wide
// head, a long action buffer), the same function runs as a chain of stage kernels (nl_wide_*,
// see "The wide variant" below), the variant named "streamed", on a buffer in its own layout;
// forward_plan picks the variant from the dims and the buffer's layout, and nl_forward_launch
// launches it.
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
// Design. nl_forward_kernel walks the batch in one of two ways, picked from B (forward_plan).
//
// The cluster walk (B >= kClusterMinB). The weights (79,844 floats at cartpole's dims, 319 KB)
// do not fit in one SM's shared memory; split by stage they fit in two. The grid is persistent:
// clusters of kClusterCtas CTAs of 16 warps, one CTA an SM, as many clusters as fit on the card
// at once (cudaOccupancyMaxActiveClusters: 39 of 3 on an H100, 117 SMs) and no more than B
// needs. Ranks g < kGruCtas are GRU CTAs: each holds the small operands and both GRU layers for
// the whole launch. The last rank is the trunk/head CTA: it holds the small operands, trunk layer
// 2 and the head. Each CTA copies its part once, by cp.async.bulk at its start, and the cluster
// walks row tiles of R = kTileRows rows: the cluster's k-th tile is cluster + k * clusters, and
// GRU CTA k % kGruCtas runs its GRU. Where the two roles do not fit at 16 rows (a long action
// buffer, a wide head beside trunk layer 2), the one-tile walk runs at every B. A GRU CTA hands each tile's
// action latent (R x 2 floats) to the trunk/head CTA through a ring of kSlots slots per GRU CTA
// in the trunk/head CTA's shared memory, written over distributed shared memory
// (st.shared::cluster) with a release arrival on the slot's "full" mbarrier; the trunk/head CTA
// frees a slot with an arrival on the GRU CTA's "empty" mbarrier. So the GRUs of the next tiles
// overlap the trunk and head of this one. Inside each CTA two groups of 8 warps pass work through
// two buffers, synchronized by named barriers rather than the whole CTA: in a GRU CTA layer 1
// (each warp 8 hidden units) runs up to two steps ahead of layer 2 and into the next tile, since
// it needs only its own last state (gru_role); in the trunk/head CTA the trunk's two layers (on
// the tensor cores) fill the next tile's hid2 while the head (on the CUDA cores) reads this one's
// (trunk_head_role).
//
// kGruCtas = 2, from the measurement on an H100 (PERF.md, PR 22): the GRU is ~92% of the MMAs
// and paces the walk (a GRU CTA takes ~24 us a 16-row tile, the trunk/head CTA ~8-10), so at
// 32,768 rows a cluster of 2 (the GRU on half the SMs) ran 0.745 ms, of 3 0.625, of 4 0.671 (30
// clusters; the trunk/head CTA the slower) and of 5 0.902, against 0.718 for one tile a CTA at
// the parent commit.
//
// The one-tile walk (B < kClusterMinB): one CTA of 16 warps an 8-row tile, as many CTAs as
// tiles, each copying every weight from L2 as its stages free shared memory (one_tile), the GRU
// a wavefront of A + 1 phases; where a few waves cover B, the cluster walk's fill and drain cost
// more than the copies.
//
// Both run the GRU's and the trunk's products on the tensor cores in split TF32 ("3xTF32",
// mma.sync.m16n8k8, the tile's rows on its N side, R / 8 n-tiles a warp): x = hi + lo with hi and
// lo TF32 values, and a*b ~ hi*hi + hi*lo + lo*hi, each of the three summed in its own f32
// accumulator (the hi*hi one by f32 adds, see mma3); one pass of TF32 errs by up to 2^-11 per
// operand and misses the 1e-3 limit. The weights are split in registers as they are loaded, once
// for all of a warp's n-tiles; each activation is split once, when it is computed, and stored as
// two planes. The head's two products run in f32 on the CUDA cores (see head_tile). A warp's
// GRU units take their r and z gates in one 16-column tile over [x; h] and the candidate's input
// and hidden halves in another, so the gate update happens in registers. The 64->2 encoder runs
// in f32 with shuffles, a warp a row. (wgmma at N = 8 rows, 64 output columns per instruction, ran
// the same work slower than mma.sync on an H100.)
//
// Shared memory at cartpole's dims (n = 5, A = 4, H = 64, hid = 128, 17 terms): a GRU
// CTA 212,048 bytes (small operands 8.7 KB, GRU layers 55.3 and 98.3 KB, the action steps
// 6.1 KB, five split GRU states 43.5 KB, one of them the zero state), the trunk/head CTA 207,568
// (the ring, small operands, trunk layer 2 65.5 KB, the head 91.5 KB, the tile's activations
// with two hid2 buffers 41.2 KB); the launch takes the larger; the one-tile walk 209,456. Where
// the whole head does not fit beside trunk layer 2 (more terms), its chunks pass through one
// chunk's room in turn for every tile, as head_tile streams them. Both read the buffer the host
// packed (forward_sections); the host packs it where the one-tile walk fits (its footprint;
// ops/pallas_nl.py resident_bytes).
//
// Bound. At B = 1000 (cartpole) the forward does 0.375 GFLOP against ~0.5 MB of weights:
// 5.6 us with every FLOP at the f32 peak of 67 TFLOP/s; 2.3 us with every product at
// 495/3 TFLOP/s (split TF32) and the fourier combine at the f32 rate. The head's products
// (0.044 GFLOP) run in f32, a cost the kernel pays against the second bound. In the cluster walk
// a CTA reads its ~160 KB of weights from L2 once a launch, where one tile a CTA reads 319 KB for
// every 8 rows (1.31 GB a forward at 32,768 rows). That traffic was not what held the kernel
// back: the GRU's mma.sync issue is. With one TF32 pass in place of three (a timing experiment
// on a cluster of 2, not the kernel) the walk ran 45% faster; without the gates' expf and tanhf
// 19%; without the head's products 4% (PERF.md, PR 22). So what is left below the roofline is the
// split-TF32 MMAs themselves, a quarter of the GRU's spent on the candidate tiles' zero halves.
//
// Numerics: accurate tanhf/sincosf/expf (no fast-math) and the per-hemisphere radius, since
// the ILT tail amplifies error near phi ~ pi/2 (pallas_nl.py:46-60).
//
// The wide variant. The resident design holds every weight of a CTA in shared memory, which
// ends at H = 64 (8 warps of 8 GRU units a layer) and ~227 KB: at width 256 the weights alone
// take 1.04 MB, at 1024 14.4 MB. Past width 128 (and below it where the resident layout does
// not fit at the dims: the host packs the wide layout there) the forward runs as a chain of
// stage kernels that nl_forward_launch puts on the caller's stream back to back: a prep kernel
// that splits the action buffer, then per GRU step (newest action first) layer 1 and layer 2,
// then trunk layer 1 (with the encoder), trunk layer 2 and the head: 2 A + 4 launches, one
// forward. The activations between stages live in scratch device memory the caller allocates
// (nl_forward_plan gives its size), stored split (hi and lo planes, written once by the
// epilogue of the stage that computes them) in blocks that a bulk copy brings whole (plane_at).
//
// Each product runs as one GEMM stage (nl_wide_gemm_kernel): a CTA owns a tile of 64 output
// columns (4 m-tiles of 16; for the GRU 64 hidden units, each with its r, z and candidate
// columns) by 32, 64 or 128 batch rows, the N side. The PR 15 kernel owned a few rows and
// every column, so it read every weight once per 8-64 rows (0.49 R FLOP per byte of L2);
// here each weight is read once per row tile and each activation once per column tile, and
// the grid is (column tiles x row tiles), so B = 1,000 still fills the SMs. (A GRU tile takes
// 32 rows, below the 64 that reuse each weight more, where 64-row tiles would leave more than a
// quarter of the SMs idle: at 1,000 rows, widths up to 768; wide_plan gives the measurement.)
// One producer warp keeps a ring of 4 stages full: each stage is 4 k-steps of the tile's
// weights and of its rows' activations, brought by cp.async.bulk onto the stage's "full"
// mbarrier; the 8 consumer warps free a stage through its "empty" mbarrier (no __syncthreads
// per tile).
// Consumer warp w owns m-tile w % 4 for the rows of its warpgroup (w / 4), 16 or 32 rows
// for the GRU, up to 64 for the trunk. The products run in split TF32 on mma.sync.m16n8k8
// (mma_split): the weights are split in registers as they are loaded, once per k-step for
// all the warp's n-tiles, the activations come split. The GRU's K loop runs over x's
// k-steps, then h's: on x's the candidate's accumulators gather its input half, on h's its
// hidden half, so no product multiplies a zero half; the epilogue forms the gates and
// h' = n + z (h - n) in registers. The trunk's epilogue is tanh + bias; the encoder runs in
// f32 in trunk layer 1's prologue, which takes all of its (few) k-steps per row tile. The
// head keeps f32 on the CUDA cores as head_tile does (split TF32 missed 1e-3 there), a CTA
// per row tile over every live column, so the sum over a row's terms stays in the CTA.
// (wgmma with A from registers, m64nNk8 over the same fragments and a B descriptor on the same
// split planes, agreed with this to 1e-5 and ran the stages 12-33% slower on an H100: ptxas
// serialized it for want of registers for the three gates' split products; PERF.md, PR 16.)
//
// Bound. At width 512 (cartpole, H = 256) a row costs 5.43 MFLOP, 95% of it in the GRU; at
// B = 20,000 that is 0.66 ms with every product three times at 495 TFLOP/s (bound_tc). At 64
// rows a tile the GRU's weights are read 313 times a step from L2 (3 GB over A = 4 steps)
// and its activations 4 times (its 4 column tiles): ~1 ms of L2 traffic at ~5.5 TB/s,
// the larger part of the time. Only offsets that overflow int limit the width
// (forward_plan).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRows = 8;  // batch rows of an n-tile (the N side of mma.m16n8k8); nl_head_kernel's CTA
constexpr int kTileRows = 16;  // batch rows of a cluster walk's tile: two n-tiles
// B from which the resident kernel walks row tiles in clusters; below it, one 8-row tile a CTA.
// On an H100 (cartpole's dims, CUDA graphs of 20 launches, PERF.md PR 22) the one-tile walk ran
// 0.2157-0.2241 / 0.2368-0.2396 / 0.2578-0.2606 ms at 10,000 / 11,000 / 12,000 rows, the cluster
// walk 0.2203-0.2293 / 0.2324-0.2348 / 0.2522-0.2551: they cross between 10,000 and 11,000.
constexpr int kClusterMinB = 11000;
constexpr int kWarps = 16;  // 8 for each GRU layer
constexpr int kThreads = 32 * kWarps;
static_assert(kWarps >= kTileRows, "the encoder gives a warp to each row of a tile");
constexpr int kGroup = 8;   // GRU hidden units per warp
constexpr int kHeadRows = 4;  // rows per thread in the head's f32 products
constexpr int kLatent = 2;  // action latent
constexpr int kBarFloats = 8;  // four mbarriers at the start of shared memory
constexpr int kGruCtas = 2;  // GRU CTAs a cluster of the resident kernel, which feed one trunk/head CTA
constexpr int kClusterCtas = kGruCtas + 1;
constexpr int kSlots = 2;  // ring slots for each GRU CTA in the trunk/head CTA
// floats of the mbarriers at the start of a resident CTA's shared memory: the trunk/head CTA's
// 3 + kGruCtas * kSlots, an even count, so that what follows stays 16-byte aligned
constexpr int kClusterBarFloats = (3 + kGruCtas * kSlots + 1) / 2 * 4;
static_assert(2 + kSlots <= kClusterBarFloats / 2, "a GRU CTA's mbarriers");
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
// the shared memory of the resident kernel's two roles at `rows` rows a tile (tile_layout).
struct ForwardLayout {
  int n, A, in_dim, H, hid;
  HeadDims head;
  int kx, k1;                       // padded widths of the GRU input and of [obs; latent]
  int small, gru1, gru2, w2;        // buffer sections before the head
  int ld_x, ld_h, ld_z, ld_hid, ld_c;  // activation row strides, 4 mod 32: no bank conflicts
  // the one-tile walk: a CTA of one 8-row tile holds its activations and, in turn, GRU layer 1
  // then trunk layer 2 in region a and GRU layer 2 then the head's chunks in region b. Its total,
  // the footprint, decides where the host packs this layout (ops/pallas_nl.py resident_bytes)
  int o_a, o_b, o_xs, o_h, o_z, o_hid1, o_hid2, o_c, footprint;
  int cluster;         // CTAs a cluster: 1 for the one-tile walk, kClusterCtas for the cluster walk
  int head_resident;   // the whole head in the trunk/head CTA (1), else one chunk at a time (0)
  // a GRU CTA: mbarriers | small | gru1 | gru2 | x [A][2 rows][ld_x] | h [5][2 rows][ld_h]
  int g_xs, g_h, g_total;
  // the trunk/head CTA: mbarriers | ring [kGruCtas][kSlots][rows][kLatent] | small | w2 | head |
  // [obs; latent] [2 rows][ld_z] | hid1 [2 rows][ld_hid] | hid2 [2][rows][ld_hid] | contrib [rows][ld_c]
  int t_small, t_w2, t_head, t_z, t_hid1, t_hid2, t_c, t_total;
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
  L.o_a = kBarFloats + L.small;
  L.o_b = L.o_a + std::max(L.gru1, L.w2);
  // the tensor cores' activations are stored split (2 kRows rows each); hid2 feeds the f32 head
  L.o_xs = L.o_b + std::max(L.gru2, L.head.chunk());
  L.o_h = L.o_xs + A * 2 * kRows * L.ld_x;  // h1 ping-pong, then h2 ping-pong
  L.o_z = L.o_h + 4 * 2 * kRows * L.ld_h;
  L.o_hid1 = L.o_z + 2 * kRows * L.ld_z;
  L.o_hid2 = L.o_hid1 + 2 * kRows * L.ld_hid;
  L.o_c = L.o_hid2 + kRows * L.ld_hid;
  L.footprint = L.o_c + kRows * L.ld_c;
  L.cluster = 1;
  return L;
}

// The two roles' shared memory at kTileRows rows a tile; returns the launch's floats (the larger).
int tile_layout(ForwardLayout& L) {
  constexpr int rows = kTileRows;
  L.g_xs = kClusterBarFloats + L.small + L.gru1 + L.gru2;
  L.g_h = L.g_xs + L.A * 2 * rows * L.ld_x;
  L.g_total = L.g_h + 5 * 2 * rows * L.ld_h;
  L.t_small = kClusterBarFloats + kGruCtas * kSlots * rows * kLatent;
  L.t_w2 = L.t_small + L.small;
  L.t_head = L.t_w2 + L.w2;
  const int acts = 2 * rows * L.ld_z + 4 * rows * L.ld_hid + rows * L.ld_c;
  L.head_resident = 4LL * (L.t_head + L.head.size() + acts) <= kSmemBudget;
  L.t_z = L.t_head + (L.head_resident ? L.head.size() : L.head.chunk());
  L.t_hid1 = L.t_z + 2 * rows * L.ld_z;
  L.t_hid2 = L.t_hid1 + 2 * rows * L.ld_hid;
  L.t_c = L.t_hid2 + 2 * rows * L.ld_hid;
  L.t_total = L.t_c + rows * L.ld_c;
  return std::max(L.g_total, L.t_total);
}

// ---- asynchronous copies and mbarriers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_init_count(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
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

// ---- thread-block clusters (the resident kernel) ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every CTA of the cluster: the writes before it, to shared memory anywhere in
// the cluster, are seen by the reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The shared::cluster address of `p`'s offset in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ void peer_store(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

// An arrival on another CTA's mbarrier that releases this thread's earlier writes to the cluster.
__device__ __forceinline__ void peer_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar) : "memory");
}

// mbar_wait for a phase that other CTAs of the cluster complete: acquires their released writes.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
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
// it, rather than by each of the warps that read it: for a tile of R rows, X [R][ld] holds hi,
// X + R * ld lo.
template <int R>
__device__ __forceinline__ void put_split(float* X, int ld, int r, int k, float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  X[r * ld + k] = __uint_as_float(hi);
  X[(R + r) * ld + k] = __uint_as_float(lo);
}

template <int R>
__device__ __forceinline__ float get_split(const float* X, int ld, int r, int k) {
  return X[r * ld + k] + X[(R + r) * ld + k];  // hi + lo: v to within 2^-22 |v|
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16 x 8 output tile (16 weight columns by one n-tile of 8 rows). Lane l holds register j at
// column m = l/4 + 8 (j/2) of the tile and batch row 2 (l%4) + j%2 of the n-tile.
struct Acc {
  float hh[4], hl[4], lh[4];  // the three products, summed apart (three dependent chains)
  __device__ __forceinline__ Acc() {
#pragma unroll
    for (int j = 0; j < 4; ++j) hh[j] = hl[j] = lh[j] = 0.f;
  }
  __device__ __forceinline__ float get(int j) const { return hh[j] + (hl[j] + lh[j]); }
};

// The A operand, four weights of a lane's fragment, split once for every n-tile it multiplies.
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ AFrag(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// The B operand: split activations X at columns k0..k0+7 of n-tile j (rows 8j..8j+7 of R).
struct BFrag {
  uint32_t hi[2], lo[2];
};

template <int R>
__device__ __forceinline__ BFrag load_b(const float* X, int ld, int k0, int j, int lane) {
  const float* x = X + (8 * j + (lane >> 2)) * ld + k0 + (lane & 3);
  const float* y = x + R * ld;
  return BFrag{{__float_as_uint(x[0]), __float_as_uint(x[4])},
               {__float_as_uint(y[0]), __float_as_uint(y[4])}};
}

__device__ __forceinline__ void mma3(Acc& acc, const AFrag& a, const BFrag& b) {
  mma_tf32(acc.lh, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(acc.hl, a.hi, b.lo[0], b.lo[1]);
  // The tensor core truncates when it adds to its accumulator, an error that grows with the
  // k-steps; the large product is formed apart and added in f32, rounded to nearest.
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.hi, b.hi[0], b.hi[1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc.hh[j] += t[j];
}

// acc[j] += W^T X over `ksteps` steps of 8 for one m-tile and every n-tile j of the R rows, W in
// fragment order [ksteps][32][4].
template <int R>
__device__ __forceinline__ void tile_gemm(Acc (&acc)[R / kRows], const float* w, const float* X,
                                          int ld, int ksteps, int lane) {
  const float4* wf = reinterpret_cast<const float4*>(w) + lane;
#pragma unroll 4
  for (int kt = 0; kt < ksteps; ++kt) {
    const float4 v = wf[kt * 32];
    const AFrag a(v.x, v.y, v.z, v.w);
#pragma unroll
    for (int j = 0; j < R / kRows; ++j) mma3(acc[j], a, load_b<R>(X, ld, kt * 8, j, lane));
  }
}

// out[r][m] = tanh(acc + bias[m]) over m-tile mt, stored split when the tensor cores read it next.
template <int R, bool kSplit>
__device__ __forceinline__ void store_tanh(const Acc (&acc)[R / kRows], const float* bias, float* out,
                                           int ld, int mt, int lane) {
#pragma unroll
  for (int j = 0; j < R / kRows; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = mt * 16 + (lane >> 2) + 8 * (e >> 1);
      const int r = 8 * j + 2 * (lane & 3) + (e & 1);
      const float v = tanhf(acc[j].get(e) + bias[m]);
      if (kSplit) {
        put_split<R>(out, ld, r, m, v);
      } else {
        out[r * ld + m] = v;
      }
    }
  }
}

__device__ __forceinline__ float logisticf(float x) { return 1.f / (1.f + expf(-x)); }

// One GRU layer at one step for hidden units 8*group .. 8*group+7 and the R rows of a tile (gates
// r/z/n, models/common.py gru_gates): h_out = (1 - z) n + z h_in, formed as n + z (h_in - n). x
// (split, row stride ldx) is the layer's input over kx steps of 8; h_in / h_out are split, row
// stride ldh. w holds the layer's tiles (per group: the r/z tile over [x; h], then the
// candidate's half tiles), bias = b_ih [3H] | b_hh [3H].
template <int R>
__device__ __forceinline__ void gru_group(const float* w, const float* bias, int H,
                                          const float* x, int ldx, int kx, const float* h_in,
                                          float* h_out, int ldh, int group, int lane) {
  constexpr int NT = R / kRows;
  const int kh = H / 8;
  const int ks = kx + kh;
  const float* w_rz = w + group * ks * 192;
  const float4* a_rz = reinterpret_cast<const float4*>(w_rz) + lane;
  const float2* a_n = reinterpret_cast<const float2*>(w_rz + ks * 128) + lane;
  Acc rz[NT], nn[NT];
#pragma unroll 2
  for (int kt = 0; kt < kx; ++kt) {  // input part: r/z, and the candidate's input half
    const float4 a = a_rz[kt * 32];
    const float2 v = a_n[kt * 32];
    const AFrag ar(a.x, a.y, a.z, a.w), an(v.x, 0.f, v.y, 0.f);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const BFrag b = load_b<R>(x, ldx, kt * 8, j, lane);
      mma3(rz[j], ar, b);
      mma3(nn[j], an, b);
    }
  }
#pragma unroll 4
  for (int kt = 0; kt < kh; ++kt) {  // hidden part: r/z, and the candidate's hidden half
    const float4 a = a_rz[(kx + kt) * 32];
    const float2 v = a_n[(kx + kt) * 32];
    const AFrag ar(a.x, a.y, a.z, a.w), an(0.f, v.x, 0.f, v.y);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const BFrag b = load_b<R>(h_in, ldh, kt * 8, j, lane);
      mma3(rz[j], ar, b);
      mma3(nn[j], an, b);
    }
  }
  const int u = group * kGroup + (lane >> 2);
  const float* b_ih = bias;
  const float* b_hh = bias + 3 * H;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = 8 * j + 2 * (lane & 3) + q;
      const float r = logisticf(rz[j].get(q) + b_ih[u] + b_hh[u]);
      const float z = logisticf(rz[j].get(2 + q) + b_ih[H + u] + b_hh[H + u]);
      const float n = tanhf(nn[j].get(q) + b_ih[2 * H + u] + r * (nn[j].get(2 + q) + b_hh[2 * H + u]));
      put_split<R>(h_out, ldh, row, u, fmaf(z, get_split<R>(h_in, ldh, row, u) - n, n));  // n + z (h - n)
    }
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

// Named barriers between the two warp groups of a resident CTA (warps 0-7 produce into two
// buffers, warps 8-15 consume; 0 is __syncthreads): each group among itself, and for each
// buffer, "written" (the producers arrive, the consumers wait) and "read" (the consumers arrive,
// the producers wait before they write the buffer again).
constexpr int kBarProducers = 1;
constexpr int kBarConsumers = 2;
constexpr int kBarWritten = 3;  // + buffer
constexpr int kBarRead = 5;     // + buffer
constexpr int kGroupThreads = kThreads / 2;

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The head and the fourier combine for the R rows of a tile on the consumer warps (t their thread,
// 0 .. kGroupThreads - 1), as head_tile computes them for 8 rows: x [R][ldx] in shared memory.
// A thread owns one column of both W_theta and W_phi for R / 2 rows, so 2 mc threads cover a
// chunk. `region` holds every chunk of the head (resident), or one chunk at a time streamed from
// src: each copy completes a phase of `bar`, `loads` counts the phases waited for over the launch,
// and the copy of the next chunk goes out once every consumer is done with this one (chunk 0 for
// the next tile where `more`). contrib is [R][cols + 4] scratch.
template <int R>
__device__ void head_rows(const float* x, int ldx, const HeadDims& h, float* region,
                          bool resident, uint64_t* bar, const float* src, int& loads, bool more,
                          float* contrib, float* __restrict__ out, int row0, int B, int t) {
  constexpr int kRowsPer = R / 2;
  const int mc = h.mc;
  const int ncols = h.D * h.terms;
  const int ldc = h.cols() + 4;
  for (int c = 0; c < h.chunks; ++c) {
    const float* chunk = region;
    if (resident) {
      chunk += c * h.chunk();
    } else {
      mbar_wait(bar, loads++ & 1);
    }
    const float* b_theta = chunk;
    const float* b_phi = chunk + mc;
    const float* c_re = chunk + 2 * mc;
    const float* c_im = chunk + 3 * mc;
    const float2* w = reinterpret_cast<const float2*>(chunk + 4 * mc);  // [Hx][mc] (theta, phi)
    for (int idx = t; idx < (R / kRowsPer) * mc; idx += kGroupThreads) {
      const int m = idx % mc;
      const int r0 = (idx / mc) * kRowsPer;
      float at[kRowsPer] = {};
      float ap[kRowsPer] = {};
      for (int k = 0; k < h.Hx; k += 4) {
        float xq[kRowsPer][4];
#pragma unroll
        for (int q = 0; q < kRowsPer; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(x + (r0 + q) * ldx + k);
          xq[q][0] = v.x; xq[q][1] = v.y; xq[q][2] = v.z; xq[q][3] = v.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float2 wv = w[(k + kk) * mc + m];
#pragma unroll
          for (int q = 0; q < kRowsPer; ++q) {
            at[q] = fmaf(xq[q][kk], wv.x, at[q]);
            ap[q] = fmaf(xq[q][kk], wv.y, ap[q]);
          }
        }
      }
      const int col = c * mc + m;
      if (col >= ncols) continue;
#pragma unroll
      for (int q = 0; q < kRowsPer; ++q) {
        const float theta = tanhf(at[q] + b_theta[m]) * kPiF;
        const float phi = fminf(fmaxf(tanhf(ap[q] + b_phi[m]) * kHalfPiF, kPhiLoF), kPhiHiF);
        float sin_phi, cos_phi, sin_theta, cos_theta;
        sincosf(phi, &sin_phi, &cos_phi);
        sincosf(theta, &sin_theta, &cos_theta);
        const float radius = phi >= 0.f ? (1.f + sin_phi) / cos_phi : cos_phi / (1.f - sin_phi);
        contrib[(r0 + q) * ldc + col] = radius * cos_theta * c_re[m] - radius * sin_theta * c_im[m];
      }
    }
    named_sync(kBarConsumers, kGroupThreads);
    if (!resident && (c + 1 < h.chunks || more) && t == 0) {  // every consumer is done with it
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk_load(region, src + ((c + 1) % h.chunks) * h.chunk(), 4u * h.chunk(), bar);
    }
  }
  for (int idx = t; idx < R * h.D; idx += kGroupThreads) {
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

// A GRU CTA (cluster rank g < kGruCtas): the GRU and the encoder for the cluster's tiles
// k = g, g + kGruCtas, ..., each tile's latent handed to the trunk/head CTA's ring slot.
// Warps 0-7 run layer 1 and warps 8-15 layer 2, warp w owning hidden units 8(w%8)..8(w%8)+7,
// over the CTA's steps q = j A + s (tile j, step s, newest action first, w_nl.py:27): layer 1
// at step q needs only its own state after q - 1, so it runs ahead of layer 2, which needs layer
// 1's state after q, by up to two steps (its two state buffers) and into the next tile. Layer 2
// runs the encoder after each tile's last step. mbarriers: 0 small + GRU layer 1, 1 GRU layer 2,
// 2 + s slot s emptied by the trunk/head CTA.
template <int R>
__device__ void gru_role(const float* __restrict__ acts, const float* __restrict__ buf, int B,
                         const ForwardLayout& L, float* smem, int g) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* s_small = smem + kClusterBarFloats;
  float* s_gru1 = s_small + L.small;
  float* s_gru2 = s_gru1 + L.gru1;
  float* xs = smem + L.g_xs;
  const int xb = 2 * R * L.ld_x;  // one action step, split
  // GRU states, split: h1 after step q at h + (q % 2) hb, h2 after step q at h + (2 + q % 2) hb,
  // the zero state at h + 4 hb (pointer arithmetic on smem, not a pointer array, keeps the loads
  // in the shared address space)
  float* h = smem + L.g_h;
  const int hb = 2 * R * L.ld_h;
  const float* hz = h + 4 * hb;
  const int H = L.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = warp % (kWarps / 2);
  if (tid == 0) {
    for (int i = 0; i < 2 + kSlots; ++i) mbar_init_count(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_load(s_small, buf, 4u * (L.small + L.gru1), bars + 0);  // small + GRU layer 1
    bulk_load(s_gru2, buf + L.small + L.gru1, 4u * L.gru2, bars + 1);  // GRU layer 2
  }
  // zeros that no tile writes: the action steps' padded columns and the zero state
  for (int idx = tid; idx < L.A * xb; idx += kThreads) {
    if (idx % L.ld_x >= L.in_dim) xs[idx] = 0.f;
  }
  for (int idx = tid; idx < hb; idx += kThreads) h[4 * hb + idx] = 0.f;
  cluster_sync();  // every CTA's mbarriers are initialized before any arrives from another

  const int A_in = L.A * L.in_dim;
  const int tiles = (B + R - 1) / R;
  const int cluster = cluster_index();
  const int clusters = cluster_count();
  const int first = cluster + g * clusters;  // the CTA's tile j is first + j kGruCtas clusters
  const int mine = first < tiles ? (tiles - first + kGruCtas * clusters - 1) / (kGruCtas * clusters) : 0;
  const int steps = mine * L.A;
  mbar_wait(bars + 0);
  if (warp < kWarps / 2) {  // layer 1
    const int t1 = tid;     // 0 .. kGroupThreads - 1
    for (int j = 0; j < mine; ++j) {
      const int row0 = (first + j * kGruCtas * clusters) * R;
      // the tile's action buffer as A steps of [R][kx], split; layer 1 alone reads it, and its
      // last step of the tile before is done (kBarProducers)
      for (int idx = t1; idx < R * A_in; idx += kGroupThreads) {
        const int r = idx / A_in;
        const int s = (idx % A_in) / L.in_dim;
        const int k = idx % L.in_dim;
        put_split<R>(xs + s * xb, L.ld_x, r, k, row0 + r < B ? acts[(row0 + r) * A_in + idx % A_in] : 0.f);
      }
      named_sync(kBarProducers, kGroupThreads);
      for (int s = 0; s < L.A; ++s) {
        const int q = j * L.A + s;
        if (q >= 2) named_sync(kBarRead + (q & 1), kThreads);  // layer 2 is done with step q - 2
        if (group < H / kGroup) {
          gru_group<R>(s_gru1, s_small, H, xs + (L.A - 1 - s) * xb, L.ld_x, L.kx / 8,
                       s == 0 ? hz : h + ((q - 1) & 1) * hb, h + (q & 1) * hb, L.ld_h, group, lane);
        }
        named_arrive(kBarWritten + (q & 1), kThreads);
        named_sync(kBarProducers, kGroupThreads);
      }
    }
  } else {  // layer 2, then the encoder
    mbar_wait(bars + 1);
    const float* w_enc = s_small + 12 * H;
    for (int j = 0; j < mine; ++j) {
      for (int s = 0; s < L.A; ++s) {
        const int q = j * L.A + s;
        named_sync(kBarWritten + (q & 1), kThreads);  // layer 1's state after step q
        if (group < H / kGroup) {
          gru_group<R>(s_gru2, s_small + 6 * H, H, h + (q & 1) * hb, L.ld_h, H / 8,
                       s == 0 ? hz : h + (2 + ((q - 1) & 1)) * hb, h + (2 + (q & 1)) * hb, L.ld_h,
                       group, lane);
        }
        named_sync(kBarConsumers, kGroupThreads);
        if (q + 2 < steps) named_arrive(kBarRead + (q & 1), kThreads);
      }
      // encoder head H -> 2 in f32 on the CUDA cores: a warp a row, its lanes split k into 16
      // parts for each of the 2 columns and meet by shuffles; lanes 0 and 1 store the latent into
      // the trunk/head CTA's slot and arrive on its "full" mbarrier
      const float* h2 = h + (2 + ((j * L.A + L.A - 1) & 1)) * hb;
      const int col = lane & 1;
      const int s = j % kSlots;
      for (int r = group; r < R; r += kWarps / 2) {
        float v = 0.f;
        for (int k = lane >> 1; k < H; k += 16) {
          v = fmaf(get_split<R>(h2, L.ld_h, r, k), w_enc[k * kLatent + col], v);
        }
#pragma unroll
        for (int off = 2; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < kLatent) {
          if (j >= kSlots) mbar_wait_cluster(bars + 2 + s, (j / kSlots - 1) & 1);
          const float* slot = smem + kClusterBarFloats + ((g * kSlots + s) * R + r) * kLatent + col;
          peer_store(peer_addr(slot, kGruCtas), v + w_enc[kLatent * H + col]);
          peer_arrive(peer_addr(bars + 3 + g * kSlots + s, kGruCtas));
        }
      }
    }
  }
  mbar_wait(bars + 1);  // no copy is in flight when the CTA ends, with or without a tile
  cluster_sync();  // the trunk/head CTA's last arrivals here have landed
}

// The trunk/head CTA (cluster rank kGruCtas), for each of the cluster's tiles in turn (tile k's
// latent from GRU CTA k % kGruCtas). Warps 0-7 run trunk layer 1 over [obs; latent]
// (normalization and contour folded in) and layer 2 on the tensor cores, into hid2 buffer k % 2;
// warps 8-15 run the head and the fourier combine on the CUDA cores from it, so the trunk of tile
// k + 1 overlaps the head of tile k. mbarriers: 0 small, 1 trunk layer 2 (and the head where it
// is resident), 2 a head chunk (streamed), 3 + g kSlots + s GRU CTA g's slot s filled (2 R
// arrivals).
template <int R>
__device__ void trunk_head_role(const float* __restrict__ obs, const float* __restrict__ buf,
                                float* __restrict__ out, int B, const ForwardLayout& L, float* smem) {
  constexpr int NT = R / kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const float* ring = smem + kClusterBarFloats;
  float* s_small = smem + L.t_small;
  float* s_w2 = smem + L.t_w2;
  float* s_head = smem + L.t_head;
  float* z1 = smem + L.t_z;
  float* hid1 = smem + L.t_hid1;
  float* hid2 = smem + L.t_hid2;  // two buffers of [R][ld_hid]
  const int H = L.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* src_w2 = buf + L.small + L.gru1 + L.gru2;
  const float* src_head = src_w2 + L.w2;
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init_count(bars + i, 1);
    for (int i = 0; i < kGruCtas * kSlots; ++i) mbar_init_count(bars + 3 + i, R * kLatent);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_load(s_small, buf, 4u * L.small, bars + 0);
    bulk_load(s_w2, src_w2, 4u * (L.w2 + (L.head_resident ? L.head.size() : 0)), bars + 1);
    if (!L.head_resident) bulk_load(s_head, src_head, 4u * L.head.chunk(), bars + 2);
  }
  cluster_sync();

  const int tiles = (B + R - 1) / R;
  const int cluster = cluster_index();
  const int clusters = cluster_count();
  const int mine = (tiles - cluster + clusters - 1) / clusters;  // tile k is cluster + k clusters
  const int hb = R * L.ld_hid;
  mbar_wait(bars + 0);
  mbar_wait(bars + 1);
  if (warp < kWarps / 2) {  // the trunk
    const float* w1 = s_small + 12 * H + kLatent * H + 4;
    const float* b1 = w1 + L.k1 * L.hid;
    const float* b2 = b1 + L.hid;
    for (int k = 0; k < mine; ++k) {
      const int row0 = (cluster + k * clusters) * R;
      const int g = k % kGruCtas;
      const int j = k / kGruCtas;
      const int s = j % kSlots;
      // [obs | latent | 0], split: the latent from GRU CTA g's slot s; the trunk's last reads of
      // z1 and hid1 (tile k - 1) are behind kBarProducers
      for (int idx = tid; idx < R * L.k1; idx += kGroupThreads) {
        const int r = idx / L.k1;
        const int c = idx % L.k1;
        float v = 0.f;
        if (c < L.n) {
          if (row0 + r < B) v = obs[(row0 + r) * L.n + c];
        } else if (c < L.n + kLatent) {
          mbar_wait_cluster(bars + 3 + g * kSlots + s, (j / kSlots) & 1);
          v = ring[((g * kSlots + s) * R + r) * kLatent + c - L.n];
        }
        put_split<R>(z1, L.ld_z, r, c, v);
      }
      named_sync(kBarProducers, kGroupThreads);
      if (tid == 0) peer_arrive(peer_addr(bars + 2 + s, g));  // GRU CTA g's slot s is free
      for (int mt = warp; mt < L.hid / 16; mt += kWarps / 2) {
        Acc acc[NT];
        tile_gemm<R>(acc, w1 + mt * (L.k1 / 8) * 128, z1, L.ld_z, L.k1 / 8, lane);
        store_tanh<R, true>(acc, b1, hid1, L.ld_hid, mt, lane);
      }
      named_sync(kBarProducers, kGroupThreads);
      if (k >= 2) named_sync(kBarRead + (k & 1), kThreads);  // the head is done with tile k - 2
      for (int mt = warp; mt < L.hid / 16; mt += kWarps / 2) {
        Acc acc[NT];
        tile_gemm<R>(acc, s_w2 + mt * (L.hid / 8) * 128, hid1, L.ld_hid, L.hid / 8, lane);
        store_tanh<R, false>(acc, b2, hid2 + (k & 1) * hb, L.ld_hid, mt, lane);
      }
      named_arrive(kBarWritten + (k & 1), kThreads);
    }
  } else {  // the head
    int loads = 0;
    for (int k = 0; k < mine; ++k) {
      named_sync(kBarWritten + (k & 1), kThreads);
      head_rows<R>(hid2 + (k & 1) * hb, L.ld_hid, L.head, s_head, L.head_resident, bars + 2, src_head,
                   loads, k + 1 < mine, smem + L.t_c, out, (cluster + k * clusters) * R, B,
                   tid - kGroupThreads);
      if (k + 2 < mine) named_arrive(kBarRead + (k & 1), kThreads);
    }
  }
  cluster_sync();  // the GRU CTAs' last arrivals here have landed
}

// The one-tile walk: a CTA owns one 8-row tile and copies every weight for it, staged as the
// stages free its shared memory (see ForwardLayout); the GRU as a wavefront of A + 1 phases.
__device__ void one_tile(const float* __restrict__ obs, const float* __restrict__ acts,
                         const float* __restrict__ buf, float* __restrict__ out, int B,
                         const ForwardLayout& L, float* smem) {
  constexpr int R = kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* s_small = smem + kBarFloats;
  float* s_a = smem + L.o_a;
  float* s_b = smem + L.o_b;
  float* xs = smem + L.o_xs;
  // GRU states: h1 ping-pong at h + {0, 1} * hb, h2 ping-pong at h + {2, 3} * hb
  float* h = smem + L.o_h;
  const int hb = 2 * R * L.ld_h;
  float* z1 = smem + L.o_z;
  float* hid1 = smem + L.o_hid1;
  float* hid2 = smem + L.o_hid2;
  const int H = L.H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * R;

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bulk_load(s_small, buf, 4u * (L.small + L.gru1), bars + 0);  // small + GRU layer 1
    bulk_load(s_b, buf + L.small + L.gru1, 4u * L.gru2, bars + 1);  // GRU layer 2
  }
  // one pass over the inputs, so that each thread waits on one global load: the action buffer
  // as A steps of [R][kx], zero-padded; [obs | latent | 0]; h = 0
  const int A_in = L.A * L.in_dim;
  const int n_xs = L.A * R * L.kx;
  const int n_z = R * L.k1;
  for (int idx = tid; idx < n_xs + n_z + R * H; idx += kThreads) {
    if (idx < n_xs) {
      const int k = idx % L.kx;
      const int r = (idx / L.kx) % R;
      const int s = idx / (L.kx * R);
      const bool live = k < L.in_dim && row0 + r < B;
      put_split<R>(xs + s * 2 * R * L.ld_x, L.ld_x, r, k, live ? acts[(row0 + r) * A_in + s * L.in_dim + k] : 0.f);
    } else if (idx < n_xs + n_z) {
      const int r = (idx - n_xs) / L.k1;
      const int k = (idx - n_xs) % L.k1;
      put_split<R>(z1, L.ld_z, r, k, (k < L.n && row0 + r < B) ? obs[(row0 + r) * L.n + k] : 0.f);
    } else {
      const int r = (idx - n_xs - n_z) / H;
      const int k = (idx - n_xs - n_z) % H;
      put_split<R>(h, L.ld_h, r, k, 0.f);
      put_split<R>(h + 2 * hb, L.ld_h, r, k, 0.f);
    }
  }
  __syncthreads();

  // GRU wavefront: phase p runs layer 1 at step p and layer 2 at step p - 1, newest action
  // first (w_nl.py:27). h1 buffer p % 2 holds layer 1's state after step p - 1.
  mbar_wait(bars + 0);
  for (int p = 0; p <= L.A; ++p) {
    if (p == 1) mbar_wait(bars + 1);
    if (p == L.A && tid == 0) {  // layer 1 is done with region a: bring the trunk's w2
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bulk_load(s_a, buf + L.small + L.gru1 + L.gru2, 4u * L.w2, bars + 2);
    }
    const int group = warp % (kWarps / 2);
    if (group < H / kGroup) {
      if (warp < kWarps / 2 && p < L.A) {
        gru_group<R>(s_a, s_small, H, xs + (L.A - 1 - p) * 2 * R * L.ld_x, L.ld_x, L.kx / 8,
                     h + (p & 1) * hb, h + ((p + 1) & 1) * hb, L.ld_h, group, lane);
      }
      if (warp >= kWarps / 2 && p >= 1) {
        gru_group<R>(s_b, s_small + 6 * H, H, h + (p & 1) * hb, L.ld_h, H / 8,
                     h + (2 + ((p - 1) & 1)) * hb, h + (2 + (p & 1)) * hb, L.ld_h, group, lane);
      }
    }
    __syncthreads();
  }
  const float* head_src = buf + L.small + L.gru1 + L.gru2 + L.w2;
  if (tid == 0) {  // the GRU is done with region b: bring the head's first chunk
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bulk_load(s_b, head_src, 4u * L.head.chunk(), bars + 3);
  }

  // encoder head H -> 2 in f32 on the CUDA cores: warp r < R owns batch row r, its lanes split k
  // into 16 parts for each of the 2 columns and meet by shuffles
  const float* w_enc = s_small + 12 * H;
  if (warp < R) {
    const float* h2 = h + (2 + (L.A & 1)) * hb;
    const int col = lane & 1;
    float v = 0.f;
    for (int k = lane >> 1; k < H; k += 16) {
      v = fmaf(get_split<R>(h2, L.ld_h, warp, k), w_enc[k * kLatent + col], v);
    }
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane < kLatent) put_split<R>(z1, L.ld_z, warp, L.n + col, v + w_enc[kLatent * H + col]);
  }
  __syncthreads();

  // trunk layer 1 over [obs; latent] (normalization and contour folded in), then layer 2
  const float* w1 = w_enc + kLatent * H + 4;
  const float* b1 = w1 + L.k1 * L.hid;
  const float* b2 = b1 + L.hid;
  for (int mt = warp; mt < L.hid / 16; mt += kWarps) {
    Acc acc[1];
    tile_gemm<R>(acc, w1 + mt * (L.k1 / 8) * 128, z1, L.ld_z, L.k1 / 8, lane);
    store_tanh<R, true>(acc, b1, hid1, L.ld_hid, mt, lane);
  }
  __syncthreads();
  mbar_wait(bars + 2);
  for (int mt = warp; mt < L.hid / 16; mt += kWarps) {
    Acc acc[1];
    tile_gemm<R>(acc, s_a + mt * (L.hid / 8) * 128, hid1, L.ld_hid, L.hid / 8, lane);
    store_tanh<R, false>(acc, b2, hid2, L.ld_hid, mt, lane);
  }
  __syncthreads();
  head_tile(hid2, L.ld_hid, L.head, s_b, bars + 3, head_src, smem + L.o_c, out, row0, B);
}

// The resident forward, one launch: the cluster walk (kWalk, clusters of kClusterCtas CTAs, R =
// kTileRows rows a tile) or the one-tile walk (R = kRows; see Design).
template <int R, bool kWalk>
__global__ void __launch_bounds__(kThreads, 1)
nl_forward_kernel(const float* __restrict__ obs, const float* __restrict__ acts,
                  const float* __restrict__ buf, float* __restrict__ out, int B,
                  const __grid_constant__ ForwardLayout L) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (!kWalk) {
    one_tile(obs, acts, buf, out, B, L, smem);
  } else if (cluster_rank() < kGruCtas) {
    gru_role<R>(acts, buf, B, L, smem, static_cast<int>(cluster_rank()));
  } else {
    trunk_head_role<R>(obs, buf, out, B, L, smem);
  }
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

// ---- the wide forward: a chain of stage kernels ----

constexpr int kWideWarps = 8;                        // consumer warps: two warpgroups
constexpr int kWideThreads = 32 * (kWideWarps + 1);  // and one producer warp
constexpr int kWideStages = 4;                       // shared-memory stages of the ring
constexpr int kWideK = 4;                            // k-steps of 8 a stage
constexpr int kColMt = 4;                            // m-tiles of 16 output columns a CTA
constexpr int kRowPad = 128;                         // scratch rows: B up to a multiple of this
constexpr int kPlane = 128;                          // floats of one (k-step, 8 rows) block
constexpr int kTrunk1Rows = 16;                      // rows a CTA of trunk layer 1
constexpr int kSmallThreads = 256;                   // the prep, trunk-1 and head kernels
constexpr int kHeadK = 128;                          // head inputs a pass through shared memory
constexpr int kTargetCtas = 132;                     // an H100 SXM's SMs
static_assert(kWideWarps == 2 * kColMt, "two warpgroups of one warp per m-tile");

// Split planes: an activation [K][rows] that the tensor cores read, K a multiple of 8, is
// stored split in blocks of one k-step by 8 rows: block (kt, rg) at (kt bp8 + rg) kPlane
// floats holds hi [2 k-halves][8 rows][4], then lo the same. A row tile's blocks of one k-step
// are contiguous (one bulk copy), and the B operand of mma.m16n8k8 at (k = t and t + 4, row
// g) is floats 4 g + t and + 32 of a block: 32 consecutive floats a warp.
__device__ __forceinline__ size_t plane_at(int k, int row, int bp8) {
  return (static_cast<size_t>(k >> 3) * bp8 + (row >> 3)) * kPlane + ((k & 7) >> 2) * 32 +
         (row & 7) * 4 + (k & 3);
}

__device__ __forceinline__ void put_plane(float* X, size_t at, float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  X[at] = __uint_as_float(hi);
  X[at + 64] = __uint_as_float(lo);
}

// mbar_wait with the spin inside the asm, so that the compiler sees no divergent exit.
__device__ __forceinline__ void mbar_spin(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
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

__device__ __forceinline__ void split4(const float4& a, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(a.x, hi[0], lo[0]);
  split(a.y, hi[1], lo[1]);
  split(a.z, hi[2], lo[2]);
  split(a.w, hi[3], lo[3]);
}

// One k-step of a 16 x 8 tile in split TF32, as mma3 forms it: the two small products summed
// in the tensor core (sm), the large one formed apart and added in f32 (hh).
__device__ __forceinline__ void mma_split(float (&hh)[4], float (&sm)[4], const uint32_t (&ahi)[4],
                                          const uint32_t (&alo)[4], const uint32_t (&b)[4]) {
  mma_tf32(sm, alo, b[0], b[1]);
  mma_tf32(sm, ahi, b[2], b[3]);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, ahi, b[0], b[1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) hh[j] += t[j];
}

// The B operand at an 8-row block of split planes: hi (k = t, t + 4), then lo.
__device__ __forceinline__ void load_b_plane(uint32_t (&b)[4], const float* blk) {
  b[0] = __float_as_uint(blk[0]);
  b[1] = __float_as_uint(blk[32]);
  b[2] = __float_as_uint(blk[64]);
  b[3] = __float_as_uint(blk[96]);
}

// One GEMM stage: out = epilogue(W^T [x; h]) for a tile of 4 m-tiles by the CTA's rows.
struct GemmArgs {
  const float* w;     // [mtiles][ks][G][128]: per m-tile, per k-step, the G gates' fragments
  const float* x;     // split planes of the x part (ksx k-steps)
  const float* h;     // split planes of the h part (ksh k-steps; null: a zero state)
  const float* bias;  // GRU: b_ih [3 cols] | b_hh [3 cols]; dense: b [cols]
  float* out;         // GRU: the new state's split planes; dense: [rows][cols] in f32
  int ks, ksx, ksh, mtiles, cols, B, bp8;
};

template <int G, int NT>
struct WideTile {
  static constexpr int kRows = 2 * 8 * NT;  // two warpgroups of NT 8-row n-tiles each
  static constexpr int kWFloats = kColMt * kWideK * G * 128;
  static constexpr int kStageFloats = kWFloats + kWideK * (kRows / 8) * kPlane;
  static constexpr int kSmemBytes = 16 * kWideStages + 4 * kWideStages * kStageFloats;
};

// G = 3: a GRU layer at one step (gates r, z, n as gru_gates, h' = n + z (h - n) with h the h
// part's state, 0 without one), the new state stored split; G = 1: tanh(x W + b) in f32.
template <int G, int NT>
__global__ void __launch_bounds__(kWideThreads, 1)
nl_wide_gemm_kernel(const __grid_constant__ GemmArgs P) {
  using T = WideTile<G, NT>;
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kWideStages;
  float* stages = smem + 4 * kWideStages;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);  // uniform in the warp
  const int lane = threadIdx.x & 31;
  const int mt0 = blockIdx.x * kColMt;
  const int row0 = blockIdx.y * T::kRows;
  const int cx = (P.ksx + kWideK - 1) / kWideK;
  const int chunks = cx + (P.ksh + kWideK - 1) / kWideK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init_count(full + s, 1);
      mbar_init_count(empty + s, kWideWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWideWarps) {  // the producer: one thread keeps the ring full
    if (lane == 0) {
      const int live = min(kColMt, P.mtiles - mt0);
      for (int c = 0; c < chunks; ++c) {
        const int s = c % kWideStages;
        if (c >= kWideStages) mbar_spin(empty + s, (c / kWideStages - 1) & 1);
        const bool in_x = c < cx;
        const int k0 = (in_x ? c : c - cx) * kWideK;
        const int kn = min(kWideK, (in_x ? P.ksx : P.ksh) - k0);
        const int kw = in_x ? k0 : P.ksx + k0;  // the weights' k-step
        float* st = stages + s * T::kStageFloats;
        mbar_expect(full + s, 4u * (live * kn * G * 128 + kn * (T::kRows / 8) * kPlane));
        for (int m = 0; m < live; ++m) {
          bulk_copy(st + m * kWideK * G * 128,
                    P.w + (static_cast<size_t>(mt0 + m) * P.ks + kw) * G * 128, 4u * kn * G * 128,
                    full + s);
        }
        const float* src = in_x ? P.x : P.h;
        for (int i = 0; i < kn; ++i) {
          bulk_copy(st + T::kWFloats + i * (T::kRows / 8) * kPlane,
                    src + (static_cast<size_t>(k0 + i) * P.bp8 + row0 / 8) * kPlane,
                    4u * (T::kRows / 8) * kPlane, full + s);
        }
      }
    }
    return;
  }

  const int wg = warp / kColMt;
  const int mt = mt0 + warp % kColMt;
  const bool live = mt < P.mtiles;
  const int g = lane >> 2;
  const int t = lane & 3;
  float hh[G][NT][4], sm[G][NT][4], nx[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      nx[j][e] = 0.f;
#pragma unroll
      for (int q = 0; q < G; ++q) hh[q][j][e] = sm[q][j][e] = 0.f;
    }
  }
  for (int c = 0; c < chunks; ++c) {
    if (G == 3 && c == cx) {  // x is done: keep the candidate's input half, start its hidden half
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          nx[j][e] = hh[G - 1][j][e] + sm[G - 1][j][e];
          hh[G - 1][j][e] = sm[G - 1][j][e] = 0.f;
        }
      }
    }
    const int s = c % kWideStages;
    const bool in_x = c < cx;
    const int kn = min(kWideK, (in_x ? P.ksx : P.ksh) - (in_x ? c : c - cx) * kWideK);
    mbar_spin(full + s, (c / kWideStages) & 1);
    const float* st = stages + s * T::kStageFloats;
    if (live) {
      const float* wf = st + (warp % kColMt) * kWideK * G * 128 + lane * 4;
      const float* af = st + T::kWFloats + wg * NT * kPlane + g * 4 + t;
      for (int i = 0; i < kn; ++i) {
        uint32_t b[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) load_b_plane(b[j], af + (i * (T::kRows / 8) + j) * kPlane);
#pragma unroll
        for (int q = 0; q < G; ++q) {
          uint32_t ahi[4], alo[4];
          split4(*reinterpret_cast<const float4*>(wf + (i * G + q) * 128), ahi, alo);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_split(hh[q][j], sm[q][j], ahi, alo, b[j]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
  if (G == 3 && chunks == cx) {  // no hidden part (the zero state)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        nx[j][e] = hh[G - 1][j][e] + sm[G - 1][j][e];
        hh[G - 1][j][e] = sm[G - 1][j][e] = 0.f;
      }
    }
  }
  if (!live) return;

  // lane holds register e of n-tile j at column mt 16 + g + 8 (e / 2), row 8 j + 2 t + e % 2
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = mt * 16 + g + 8 * (e >> 1);
      const int row = row0 + (wg * NT + j) * 8 + 2 * t + (e & 1);
      if (col >= P.cols || row >= P.B) continue;
      if (G == 3) {
        const float* b_ih = P.bias;
        const float* b_hh = P.bias + 3 * P.cols;
        const float r = logisticf(hh[0][j][e] + sm[0][j][e] + __ldg(b_ih + col) + __ldg(b_hh + col));
        const float z = logisticf(hh[1][j][e] + sm[1][j][e] + __ldg(b_ih + P.cols + col) +
                                  __ldg(b_hh + P.cols + col));
        const float n = tanhf(nx[j][e] + __ldg(b_ih + 2 * P.cols + col) +
                              r * (hh[G - 1][j][e] + sm[G - 1][j][e] + __ldg(b_hh + 2 * P.cols + col)));
        const size_t at = plane_at(col, row, P.bp8);
        const float h = P.h ? P.h[at] + P.h[at + 64] : 0.f;
        put_plane(P.out, at, fmaf(z, h - n, n));  // n + z (h - n)
      } else {
        P.out[static_cast<size_t>(row) * P.cols + col] =
            tanhf(hh[0][j][e] + sm[0][j][e] + __ldg(P.bias + col));
      }
    }
  }
}

// The offsets and tiles of a wide forward (widths and offsets in floats, H and hid padded).
struct WidePlan {
  int B, n, A, in_dim, H, hid;
  HeadDims head;
  int kx, k1, bp8;
  int nt_gru, nt_dense, head_rows;  // n-tiles a warp in the GRU and trunk-2 stages; head rows a CTA
  long long o_gru1, o_gru2, o_w2, o_head, buf_len;  // weight buffer sections
  long long s_h, s_hid1, s_hid2, scratch;           // scratch: x planes [A], h planes [4], hid1, hid2
};

// The split action buffer: A steps of x planes [kx][bp], zero past in_dim and past B.
__global__ void __launch_bounds__(kSmallThreads)
nl_wide_prep_kernel(const float* __restrict__ acts, float* __restrict__ xs, int B, int A,
                    int in_dim, int kx, int bp8) {
  const size_t per = static_cast<size_t>(kx) * bp8 * 8;  // entries a step
  const size_t total = per * A;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int s = static_cast<int>(i / per);
    const size_t rem = i % per;
    const int row = static_cast<int>(rem / kx);
    const int k = static_cast<int>(rem % kx);
    const float v = row < B && k < in_dim ? acts[(static_cast<size_t>(row) * A + s) * in_dim + k] : 0.f;
    put_plane(xs + s * per * 2, plane_at(k, row, bp8), v);
  }
}

// Trunk layer 1 for kTrunk1Rows rows and every column: the encoder H -> 2 in f32 over the last
// GRU state (its k split between the two halves of the block, each lane a (k-half, k % 4)
// stripe, met by shuffles), [obs; latent] split into shared memory, then the product over its
// k1 / 8 k-steps with the weights' fragments read from global memory, tanh + bias, stored split.
__global__ void __launch_bounds__(kSmallThreads)
nl_wide_trunk1_kernel(const float* __restrict__ obs, const float* __restrict__ buf,
                      const float* __restrict__ h2, float* __restrict__ hid1,
                      const __grid_constant__ WidePlan W) {
  extern __shared__ __align__(16) float sm1[];
  float* lat = sm1;      // [2 halves][kTrunk1Rows][2]
  float* z = sm1 + 64;   // [k1 / 8][2 row blocks][kPlane]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kTrunk1Rows;
  const int H = W.H;
  const float* w_enc = buf + 12 * H;
  {
    const int q = tid & 127;
    const int par = tid >> 7;
    const int rl = (q >> 6) * 8 + ((q >> 3) & 7);
    const int k4 = q & 7;  // k % 8 of the lane's stripe
    float a0 = 0.f, a1 = 0.f;
    if (row0 + rl < W.B) {
      for (int kt = par; kt < H / 8; kt += 2) {
        const int k = kt * 8 + k4;
        const size_t at = plane_at(k, row0 + rl, W.bp8);
        const float v = h2[at] + h2[at + 64];
        a0 = fmaf(v, __ldg(w_enc + 2 * k), a0);
        a1 = fmaf(v, __ldg(w_enc + 2 * k + 1), a1);
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, off);
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    }
    if (k4 == 0) {
      lat[(par * kTrunk1Rows + rl) * 2] = a0;
      lat[(par * kTrunk1Rows + rl) * 2 + 1] = a1;
    }
  }
  __syncthreads();
  const float* b_enc = buf + 14 * H;
  for (int i = tid; i < kTrunk1Rows * W.k1; i += kSmallThreads) {
    const int rl = i / W.k1;
    const int k = i % W.k1;
    const int row = row0 + rl;
    float v = 0.f;
    if (row < W.B && k < W.n) {
      v = obs[static_cast<size_t>(row) * W.n + k];
    } else if (row < W.B && k < W.n + kLatent) {
      const int c = k - W.n;
      v = lat[rl * 2 + c] + lat[(kTrunk1Rows + rl) * 2 + c] + __ldg(b_enc + c);
    }
    put_plane(z, ((k >> 3) * 2 + (rl >> 3)) * kPlane + ((k & 7) >> 2) * 32 + (rl & 7) * 4 + (k & 3), v);
  }
  __syncthreads();
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* w1 = buf + 14 * H + 4;
  const float* b1 = w1 + W.k1 * W.hid;
  const int ks = W.k1 / 8;
  for (int mt = warp; mt < W.hid / 16; mt += kSmallThreads / 32) {
    float hh[2][4] = {}, sm[2][4] = {};
    for (int kt = 0; kt < ks; ++kt) {
      uint32_t ahi[4], alo[4];
      split4(__ldg(reinterpret_cast<const float4*>(w1 + (mt * ks + kt) * 128) + lane), ahi, alo);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        load_b_plane(b, z + (kt * 2 + j) * kPlane + g * 4 + t);
        mma_split(hh[j], sm[j], ahi, alo, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = mt * 16 + g + 8 * (e >> 1);
        const int row = row0 + j * 8 + 2 * t + (e & 1);
        if (row < W.B) put_plane(hid1, plane_at(col, row, W.bp8), tanhf(hh[j][e] + sm[j][e] + __ldg(b1 + col)));
      }
    }
  }
}

// The head over W.head_rows rows and every live column (so a row's sum over its terms stays
// in the CTA): each thread one column for kHeadRows rows at a time, its theta/phi weights read
// from the repack_head buffer in global memory, the rows' inputs through shared memory kHeadK
// columns at a time, summed in k order in f32 on the CUDA cores as head_tile sums them; then
// the sphere map, the per-term contributions and their sum.
__global__ void __launch_bounds__(kSmallThreads)
nl_wide_head_kernel(const float* __restrict__ x, const float* __restrict__ buf,
                    float* __restrict__ out, const __grid_constant__ WidePlan W) {
  extern __shared__ __align__(16) float hs[];
  const HeadDims& h = W.head;
  const int R = W.head_rows;
  const int ncols = h.D * h.terms;
  const int ldx = kHeadK + 4;
  const int ldc = ncols + 4;
  float* xs = hs;                 // [R][ldx]
  float* contrib = hs + R * ldx;  // [R][ldc]
  const float* head = buf + W.o_head;
  const int row0 = blockIdx.x * R;
  const int pairs = ncols * (R / kHeadRows);
  for (int p0 = 0; p0 < pairs; p0 += kSmallThreads) {
    const int idx = p0 + threadIdx.x;
    const bool live = idx < pairs;
    const int col = idx % ncols;
    const int r0 = idx / ncols * kHeadRows;
    const int m = col % h.mc;
    const float* chunk = head + static_cast<size_t>(col / h.mc) * h.chunk();
    const float2* w = reinterpret_cast<const float2*>(chunk + 4 * h.mc) + m;  // [Hx][mc]
    float at[kHeadRows] = {};
    float ap[kHeadRows] = {};
    for (int k0 = 0; k0 < W.hid; k0 += kHeadK) {
      const int kn = min(kHeadK, W.hid - k0);
      __syncthreads();
      for (int i = threadIdx.x; i < R * kn; i += kSmallThreads) {
        const int r = i / kn;
        const int k = i % kn;
        xs[r * ldx + k] = row0 + r < W.B ? x[static_cast<size_t>(row0 + r) * W.hid + k0 + k] : 0.f;
      }
      __syncthreads();
      if (live) {
        for (int k = 0; k < kn; ++k) {
          const float2 wv = __ldg(w + static_cast<size_t>(k0 + k) * h.mc);
#pragma unroll
          for (int q = 0; q < kHeadRows; ++q) {
            const float xv = xs[(r0 + q) * ldx + k];
            at[q] = fmaf(xv, wv.x, at[q]);
            ap[q] = fmaf(xv, wv.y, ap[q]);
          }
        }
      }
    }
    if (!live) continue;
    const float bt = __ldg(chunk + m), bp = __ldg(chunk + h.mc + m);
    const float cre = __ldg(chunk + 2 * h.mc + m), cim = __ldg(chunk + 3 * h.mc + m);
#pragma unroll
    for (int q = 0; q < kHeadRows; ++q) {
      const float theta = tanhf(at[q] + bt) * kPiF;
      const float phi = fminf(fmaxf(tanhf(ap[q] + bp) * kHalfPiF, kPhiLoF), kPhiHiF);
      float sin_phi, cos_phi, sin_theta, cos_theta;
      sincosf(phi, &sin_phi, &cos_phi);
      sincosf(theta, &sin_theta, &cos_theta);
      const float radius = phi >= 0.f ? (1.f + sin_phi) / cos_phi : cos_phi / (1.f - sin_phi);
      contrib[(r0 + q) * ldc + col] = radius * cos_theta * cre - radius * sin_theta * cim;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * h.D; idx += kSmallThreads) {
    const int r = idx / h.D;
    const int d = idx % h.D;
    if (row0 + r >= W.B) continue;
    const float* c = contrib + r * ldc + d * h.terms;
    float acc = 0.f;
    for (int tt = 0; tt < h.terms; ++tt) acc += c[tt];
    out[static_cast<size_t>(row0 + r) * h.D + d] = acc;
  }
}

long long wide_gru_floats(int kx, int H) { return 3LL * round_up(H, 16) * (kx + H); }

// Zero floats that end the wide layout's buffer, so that its length tells it from the resident
// layout's at every width: the two GRU orders have one length where H is a multiple of 16.
constexpr int kWideTag = 4;

WidePlan wide_plan(int B, int n, int A, int in_dim, int H, int hid, int D, int terms) {
  WidePlan W;
  W.B = B; W.n = n; W.A = A; W.in_dim = in_dim; W.H = H; W.hid = hid;
  W.head = head_dims(hid, D, terms);
  W.kx = round_up(in_dim, 8);
  W.k1 = round_up(n + kLatent, 8);
  W.o_gru1 = 12LL * H + kLatent * H + 4 + static_cast<long long>(W.k1) * hid + 2LL * hid;
  W.o_gru2 = W.o_gru1 + wide_gru_floats(W.kx, H);
  W.o_w2 = W.o_gru2 + wide_gru_floats(H, H);
  W.o_head = W.o_w2 + static_cast<long long>(hid) * hid;
  W.buf_len = W.o_head + static_cast<long long>(W.head.chunks) * W.head.chunk() + kWideTag;
  const long long bp = round_up(B > 0 ? B : 1, kRowPad);
  W.bp8 = static_cast<int>(bp / 8);
  W.s_h = 2LL * A * W.kx * bp;
  W.s_hid1 = W.s_h + 8LL * H * bp;
  W.s_hid2 = W.s_hid1 + 2LL * hid * bp;
  W.scratch = W.s_hid2 + static_cast<long long>(hid) * bp;
  // the most rows a tile while (column tiles x row tiles) fills the SMs, else the fewest. The
  // GRU stage takes 64 rows where that grid covers three quarters of the SMs: at 1,000 rows on
  // an H100, 32-row tiles ran 28% and 20% faster at widths 256 and 512 (64-row grids of 32 and
  // 64 CTAs), 64-row tiles 17% faster at 1,024 (128 CTAs; PERF.md, PR 16)
  const long long gru_cols = (round_up(H, 16) / 16 + kColMt - 1) / kColMt;
  const long long dense_cols = (hid / 16 + kColMt - 1) / kColMt;
  W.nt_gru = 4 * gru_cols * ((B + 63) / 64) >= 3 * kTargetCtas ? 4 : 2;
  W.nt_dense = dense_cols * ((B + 127) / 128) >= kTargetCtas ? 8
               : dense_cols * ((B + 63) / 64) >= kTargetCtas ? 4 : 2;
  W.head_rows = (B + 31) / 32 >= kTargetCtas ? 32 : 8;
  return W;
}

long long wide_gemm_smem(int G, int nt) {
  if (G == 3) return nt == 4 ? WideTile<3, 4>::kSmemBytes : WideTile<3, 2>::kSmemBytes;
  return nt == 8 ? WideTile<1, 8>::kSmemBytes
         : nt == 4 ? WideTile<1, 4>::kSmemBytes : WideTile<1, 2>::kSmemBytes;
}

long long wide_trunk1_smem(const WidePlan& W) { return 4LL * (64 + W.k1 / 8 * 2 * kPlane); }

long long wide_head_smem(const WidePlan& W) {
  return 4LL * W.head_rows * (kHeadK + 4 + W.head.D * W.head.terms + 4);
}

long long wide_smem(const WidePlan& W) {
  long long m = wide_gemm_smem(3, W.nt_gru);
  m = std::max(m, wide_gemm_smem(1, W.nt_dense));
  m = std::max(m, wide_trunk1_smem(W));
  return std::max(m, wide_head_smem(W));
}

template <int G, int NT>
void launch_gemm(const GemmArgs& P, cudaStream_t st) {
  using T = WideTile<G, NT>;
  const dim3 grid((P.mtiles + kColMt - 1) / kColMt, (P.B + T::kRows - 1) / T::kRows);
  nl_wide_gemm_kernel<G, NT><<<grid, kWideThreads, T::kSmemBytes, st>>>(P);
}

void launch_gru(const GemmArgs& P, int nt, cudaStream_t st) {
  if (nt == 4) {
    launch_gemm<3, 4>(P, st);
  } else {
    launch_gemm<3, 2>(P, st);
  }
}

void launch_dense(const GemmArgs& P, int nt, cudaStream_t st) {
  if (nt == 8) {
    launch_gemm<1, 8>(P, st);
  } else if (nt == 4) {
    launch_gemm<1, 4>(P, st);
  } else {
    launch_gemm<1, 2>(P, st);
  }
}

// The wide forward's 2 A + 4 launches on `st`: p = obs, acts, buf, out, scratch.
int wide_launch(const float* const* p, const WidePlan& W, cudaStream_t st) {
  const float* buf = p[2];
  float* scratch = const_cast<float*>(p[4]);
  const int B = W.B, H = W.H, hid = W.hid;
  const long long bp = 8LL * W.bp8;
  const long long xb = 2LL * W.kx * bp;  // one step's x planes
  const long long hb = 2LL * H * bp;     // one state's planes: h1 at 0, 1; h2 at 2, 3
  float* hs = scratch + W.s_h;
  const long long prep = static_cast<long long>(W.A) * W.kx * bp;
  nl_wide_prep_kernel<<<static_cast<int>(std::min<long long>((prep + kSmallThreads - 1) / kSmallThreads,
                                                             8 * kTargetCtas)),
                        kSmallThreads, 0, st>>>(p[1], scratch, B, W.A, W.in_dim, W.kx, W.bp8);
  const int mt_h = round_up(H, 16) / 16;
  for (int s = 0; s < W.A; ++s) {  // newest action first (w_nl.py:27)
    const int src = W.A - 1 - s;
    const float* h1 = s ? hs + (s & 1) * hb : nullptr;
    const float* h2 = s ? hs + (2 + (s & 1)) * hb : nullptr;
    float* h1_new = hs + ((s + 1) & 1) * hb;
    launch_gru(GemmArgs{buf + W.o_gru1, scratch + src * xb, h1, buf, h1_new, W.kx / 8 + H / 8, W.kx / 8,
                        s ? H / 8 : 0, mt_h, H, B, W.bp8}, W.nt_gru, st);
    launch_gru(GemmArgs{buf + W.o_gru2, h1_new, h2, buf + 6 * H, hs + (2 + ((s + 1) & 1)) * hb, 2 * H / 8,
                        H / 8, s ? H / 8 : 0, mt_h, H, B, W.bp8}, W.nt_gru, st);
  }
  nl_wide_trunk1_kernel<<<(B + kTrunk1Rows - 1) / kTrunk1Rows, kSmallThreads, wide_trunk1_smem(W), st>>>(
      p[0], buf, hs + (2 + (W.A & 1)) * hb, scratch + W.s_hid1, W);
  const float* b2 = buf + 14 * H + 4 + W.k1 * hid + hid;
  launch_dense(GemmArgs{buf + W.o_w2, scratch + W.s_hid1, nullptr, b2, scratch + W.s_hid2, hid / 8, hid / 8, 0,
                        hid / 16, hid, B, W.bp8}, W.nt_dense, st);
  nl_wide_head_kernel<<<(B + W.head_rows - 1) / W.head_rows, kSmallThreads, wide_head_smem(W), st>>>(
      scratch + W.s_hid2, buf, const_cast<float*>(p[3]), W);
  return static_cast<int>(cudaGetLastError());
}

int g_smem_limit = 0;  // bytes of dynamic shared memory a block may use, set by nl_init
// clusters of the resident kernel that fit on the device at once (one CTA an SM), set by nl_init
int g_clusters = 0;

int grid_for(int B, int rows) { return (B + rows - 1) / rows; }

enum { kResident = 0, kStreamed = 1, kBadDims = -1, kNoFit = -2, kTooBig = -3 };

// dims of a forward launch: B, n, A, in_dim, H, hid, D, terms, buf_len (floats), with H and
// hid the model's widths. The buffer's length says its layout (ops/pallas_nl.py wide_layout
// picks it on the host): the resident one, which exists up to H = 64 (8 warps of 8 GRU units a
// layer), gives kResident where its footprint fits in shared memory at these dims, with the walk
// set (from kClusterMinB rows the cluster walk where both roles fit, else the one-tile walk), and
// kNoFit where it does not (a buffer packed for fewer action steps); the wide one gives
// kStreamed (a chain of stage kernels) at any width, or kTooBig where an offset would overflow
// int. Malformed dims or a length of neither layout give kBadDims.
int forward_plan(const int* dims, int n_dims, ForwardLayout& L, WidePlan& W) {
  if (n_dims != 9) return kBadDims;
  const int B = dims[0], n = dims[1], A = dims[2], in_dim = dims[3];
  const int H = round_up(dims[4], kGroup), hid = round_up(dims[5], 16);
  const int D = dims[6], terms = dims[7], buf_len = dims[8];
  if (B < 0 || n <= 0 || A <= 0 || in_dim <= 0 || H <= 0 || hid <= 0 || D <= 0 || terms <= 0) {
    return kBadDims;
  }
  if (H <= kGroup * kWarps / 2) {
    L = forward_layout(n, A, in_dim, H, hid, D, terms);
    if (L.small + L.gru1 + L.gru2 + L.w2 + L.head.size() == buf_len) {
      if (4LL * L.footprint > kSmemBudget) return kNoFit;
      if (B >= kClusterMinB && 4LL * tile_layout(L) <= kSmemBudget) L.cluster = kClusterCtas;
      return kResident;
    }
  }
  W = wide_plan(B, n, A, in_dim, H, hid, D, terms);
  if (W.buf_len > INT_MAX || W.scratch > INT_MAX || 2LL * H * 8 * W.bp8 > INT_MAX) return kTooBig;
  return W.buf_len == buf_len ? kStreamed : kBadDims;
}

long long resident_smem(const ForwardLayout& L) {
  return 4LL * (L.cluster == 1 ? L.footprint : std::max(L.g_total, L.t_total));
}

long long plan_smem(int variant, const ForwardLayout& L, const WidePlan& W) {
  if (variant == kResident) return resident_smem(L);
  if (variant == kStreamed) return wide_smem(W);
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

// CTAs of a resident launch, each of which copies its weights once: for the cluster walk, clusters
// enough for every GRU CTA to have a tile and no more than fit at once.
long long resident_ctas(int B, const ForwardLayout& L) {
  if (L.cluster == 1) return grid_for(B, kRows);
  const int tiles = grid_for(B, kTileRows);
  return static_cast<long long>(std::min(g_clusters, (tiles + kGruCtas - 1) / kGruCtas)) * kClusterCtas;
}

template <int R, bool kWalk>
int resident_launch(const float* const* p, int B, const ForwardLayout& L, cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(resident_ctas(B, L)));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = resident_smem(L);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = kWalk ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, nl_forward_kernel<R, kWalk>, p[0], p[1], p[2],
                                             const_cast<float*>(p[3]), B, L));
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
  const void* kernels[] = {reinterpret_cast<const void*>(nl_forward_kernel<kRows, false>),
                           reinterpret_cast<const void*>(nl_forward_kernel<kTileRows, true>),
                           reinterpret_cast<const void*>(nl_head_kernel),
                           reinterpret_cast<const void*>(nl_wide_gemm_kernel<3, 2>),
                           reinterpret_cast<const void*>(nl_wide_gemm_kernel<3, 4>),
                           reinterpret_cast<const void*>(nl_wide_gemm_kernel<1, 2>),
                           reinterpret_cast<const void*>(nl_wide_gemm_kernel<1, 4>),
                           reinterpret_cast<const void*>(nl_wide_gemm_kernel<1, 8>),
                           reinterpret_cast<const void*>(nl_wide_trunk1_kernel),
                           reinterpret_cast<const void*>(nl_wide_head_kernel)};
  for (const void* k : kernels) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, g_smem_limit);
    }
  }
  // the cluster walk's clusters at one CTA an SM (the whole opt-in shared memory)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = g_smem_limit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&g_clusters, nl_forward_kernel<kTileRows, true>, &cfg);
  }
  if (err == cudaSuccess && g_clusters < 1) err = cudaErrorInvalidConfiguration;
  return static_cast<int>(err);
}

// The plan of a forward launch with these dims, in info[0..9]: rows and columns of a GRU tile
// (0 columns: all), rows of a trunk-2 tile, rows of a head tile, device launches per forward,
// the largest dynamic shared memory of a launch (bytes), the scratch it needs (floats), the
// resident kernel's CTAs (each loads its weights once) and CTAs a cluster. nl_init must have run
// on the current device (the CTAs depend on the clusters that fit). Returns
// the variant: 0 resident, 1 streamed (the wide chain), or -1 for malformed dims or a buffer of
// neither layout's length, -2 for a buffer in the resident layout that does not fit in shared
// memory at these dims, -3 where an offset would overflow int.
int nl_forward_plan(const int* dims, int n_dims, long long* info) {
  ForwardLayout L;
  WidePlan W;
  const int v = forward_plan(dims, n_dims, L, W);
  for (int i = 0; i < 10; ++i) info[i] = 0;
  if (v == kResident) {
    info[0] = L.cluster == 1 ? kRows : kTileRows;
    info[4] = 1;
    info[5] = plan_smem(v, L, W);
    info[7] = resident_ctas(dims[0], L);
    info[8] = L.cluster;
  } else if (v == kStreamed) {
    info[0] = 16LL * W.nt_gru;
    info[1] = kColMt * 16;
    info[2] = 16LL * W.nt_dense;
    info[3] = W.head_rows;
    info[4] = 2LL * W.A + 4;
    info[5] = wide_smem(W);
    info[6] = W.scratch;
  }
  return v;
}

// The dynamic shared memory, in bytes, of a launch with these dims (as the launchers take
// them; the largest of the chain's), or -1 if the launcher refuses them.
long long nl_forward_smem_bytes(const int* dims, int n_dims) {
  ForwardLayout L;
  WidePlan W;
  return plan_smem(forward_plan(dims, n_dims, L, W), L, W);
}

long long nl_head_smem_bytes(const int* dims, int n_dims) {
  HeadDims h;
  return head_plan(dims, n_dims, h);
}

// ptrs: obs [B, n], acts [B, A*in_dim], buf (repack_nl_forward), out [B, D], and for the
// streamed variant scratch (nl_forward_plan's info[6] floats).
// dims: B, n, A, in_dim, H, hid, D, terms, buf_len (floats).
// Launches the variant forward_plan picks on `stream`; returns the cudaError_t of the launches
// (0 on success).
int nl_forward_launch(const void* const* ptrs, int n_ptrs, const int* dims, int n_dims,
                      void* stream) {
  ForwardLayout L;
  WidePlan W;
  const int variant = forward_plan(dims, n_dims, L, W);
  if (n_ptrs != (variant == kStreamed ? 5 : 4)) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = check_smem(plan_smem(variant, L, W))) return err;
  const int B = dims[0];
  if (B == 0) return 0;
  const float* const* p = reinterpret_cast<const float* const*>(ptrs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == kStreamed) return wide_launch(p, W, st);
  return L.cluster == 1 ? resident_launch<kRows, false>(p, B, L, st)
                        : resident_launch<kTileRows, true>(p, B, L, st);
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
