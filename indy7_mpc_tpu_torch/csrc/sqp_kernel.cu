// Kernel K1: the whole batched SQP solve, one thread block per lane, or one
// thread-block cluster per lane past 174 knots (sm_90a).
//
// Replaces the Pallas TPU kernel indy7_mpc_tpu/ops/pallas/sqp_kernel.py
// (_sqp_kernel, launched by sqp_solve_pallas).  Per lane and per SQP
// iteration it runs the same four stages:
//   1. linearize every knot: forward dynamics (RNEA + CRBA + LDL^T), the
//      M^-1 columns, da/dx from twelve one-tangent Dual passes of RNEA and
//      of the wrench map (the wrench's q-dependence included), Euler
//      defects, Gauss-Newton cost data with 1/(|err|+eps) scaling and the
//      joint-range barrier, and the alpha = 0 merit as a byproduct;
//   2. the Riccati backward sweep, rho on Quu, 6x6 LDL^T, S
//      re-symmetrized at every knot (without it f32 torques blow up to NaN
//      after ~300 closed-loop ticks at N=64);
//   3. the forward rollout of the delta policy;
//   4. the merit line search over the halving alphas (the largest accepted
//      alpha wins), the masked update, the step-norm exit and the rho
//      backoff.
//
// What bounds it on the card: latency.  The work (about 1.6e5 flops per
// knot per iteration, counted by roofline.k1_work; ~10 KB of inputs and
// outputs per lane) is far below the card's rates; the floor is the
// serial chain of dependent small
// products, above all the Riccati sweep over the knots.  The design: one
// block per lane.  The lane's horizon (trajectory, goals and every
// per-knot array of the solve, 1,316 bytes per knot) lives in dynamic
// shared memory, gathered from the lane-major inputs at the start and
// scattered back at the end.  The threads of the block stride over each
// stage's independent work, in the structure of the TPU kernel: stage 1
// over knots and then over (knot, tangent) pairs, stage 2 over the entries
// of each knot's products in three passes a knot (3 barriers: Quu is formed
// from S beside SA, SB and Sc, and factored once by one thread while the
// others form Qxx, Qxu, qx and qu; the threads that form S' solve the K
// columns they need from that factor and store S' symmetrized; each kind
// of entry starts on a warp boundary), stage 3 over the state rows (1
// barrier a knot), stage 4 over (knot, alpha) pairs.
// Every cooperative loop is `for (i = tid; i < n; i += nthreads)` between
// barriers, and every sum is taken by one thread in a fixed order, so the
// result is the same bits for any block size.  No tensor cores: the
// products are 12x12 and the recursion needs full f32.  The rigid-body
// items of stages 1 and 4 and the Riccati sweep's LDL^T run rbd.cuh's
// routines, whose per-link arrays live in registers: they take the 255
// registers a thread may have, so 256 threads fill an SM's register file:
// one block per SM, 64 of 132 SMs at B=64.  The local-memory frame is what
// sincosf's slow path, the rollout's du and a few words of loop state need
// (64 bytes a thread in sqp_kernel<false>, ptxas, PERF.md): a frame for
// per-link arrays would go through L2 and slow linearize and the line
// search the more blocks run at once.
//
// Past 174 knots one block's 227 KB cannot hold the horizon, which the TPU
// kernel keeps whole in VMEM.  The lane then takes a cluster of C blocks
// (C the smallest that fits, at most the portable 8), on C SMs of one GPC:
// block r holds the contiguous segment of knots [r*seg, (r+1)*seg), seg =
// ceil(N/C), in the same layout, with its own copy of the fixed region,
// and reaches the other blocks' knots through distributed shared memory
// (cooperative_groups' map_shared_rank).  Stages 1 and 4 run in every
// block on its own knots at once; they read the knot after the segment
// (X, dX) over DSMEM.  The Riccati sweep and the rollout stay serial: the
// block that owns the current segment works while the others wait, and the
// next block reads S and s (stage 2), or the dx after the segment (stage 3,
// left in the finished block's Sc), over DSMEM, a cluster barrier at each
// segment boundary: every DSMEM access is a load.  Every sum over knots is still
// taken by one thread in knot order, reading the other blocks' terms over
// DSMEM (each block takes it and gets the same bits, so each keeps its own
// lane state), so the result is the same bits for every C.  C = 1 is the
// kernel without the cluster (sqp_kernel<false>, a plain launch).
//
// Stage clocks (tracing.py): every launch takes a device word and an
// accumulator of kClockSlots counters.  Thread 0 of each block reads the
// word once; when it is set, that thread reads clock64() after the barrier
// that closes each stage and adds the stage's cycles at once (one
// timestamp, kept in the lane state).  In the cluster kernel the same
// thread also reads clock64() on both sides of each segment's cluster
// barrier in stages 2 and 3 and adds the cycles between to the hand-off
// slot: the block's wait for the other blocks' segments, a part of the
// riccati and rollout slots (0 at C = 1).  The thread that factors Quu
// counts its pivots off rcp_rn()'s fast path in one more slot.  Off, they
// cost one load a block.  Either way the outputs are the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

#include "rbd.cuh"

namespace cg = cooperative_groups;

namespace indy7 {

// Cost, SQP and horizon settings; mirrored by SolveParams in
// ops/kernels/_abi.py.  `stages` < 4 cuts every iteration after stage 1,
// 2 or 3 (a profiling aid: the outputs are then meaningless).
struct SolveParams {
  float dt, dQ, R, QN, eps, q_barrier, q_barrier_margin;
  float merit_mu, step_tol, rho_min, rho_max, rho_factor;
  int regularize, max_iters, num_alphas, N, B, use_wrench, stages;
};

constexpr int kMaxThreads = 256;
constexpr int kWarp = 32;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kMaxCluster = 8;      // the portable cluster size

// Shared floats per knot, region by region (each region holds a block's
// knots).
constexpr int kX = 12, kU = 6, kG = 3, kDa = 72, kMinv = 36, kD = 12;
constexpr int kQv = 12, kSc = 8, kJ = 18, kK = 72, kKff = 6, kDX = 12, kDU = 6;
// Work, at least kWork floats a knot: stage 1's a (6), L (36) and invD (6)
// of the knot, then stage 4's costs and defect norms of the knot's (knot,
// alpha) pairs, in two rows of the alpha slots (at least kAlphaSlots, and
// num_alphas if more: the layout is sized from num_alphas at launch).
constexpr int kWork = 48;
constexpr int kAlphaSlots = 16;
// Terms of the knot's merit and step norm, by index.
constexpr int kTerms = 6;
constexpr int kTErr2 = 0, kTBar = 1, kTV2 = 2, kTU2 = 3, kTCv = 4, kTNrm2 = 5;
// Floats a knot and of the fixed region at up to kAlphaSlots alphas.
constexpr int kKnotFloats = 329;
static_assert(kKnotFloats == kX + kU + kG + kDa + kMinv + kD + kQv + kSc + kJ +
                                 kK + kKff + kDX + kDU + kWork + kTerms,
              "kKnotFloats");
static_assert(2 * kAlphaSlots <= kWork, "stage 4 pairs fit the work region");

// Per-lane scalars, in the first floats of the fixed region, and the
// block's stage clocks (thread 0's; see stage_clock).
struct LaneState {
  float rho, base_merit, scale;
  int done;
  int clocks;                  // the stage clocks are on in this launch
  unsigned int t_entry;        // clock64()'s low 32 bits at the block's entry
  unsigned long long t_stage;  // clock64() at the last stage boundary
};
constexpr int kState = 8;
static_assert(sizeof(LaneState) == 4 * kState, "kState");
// Fixed region: the lane state, S (symmetric), SA, SB, Qxx, Qxu, Quu (then
// its LDL^T factor), s, Sc, qx, qu, the per-alpha merits and the wrench.
constexpr int kFixedFloats = 684;
static_assert(kFixedFloats ==
                  kState + 144 * 3 + 72 * 2 + 36 + 12 * 3 + 6 + kAlphaSlots + 6,
              "kFixedFloats");

// The slots of the stage clocks' accumulator (tracing.K1_SLOTS): the
// cycles of the prologue's load, of stages 1-4 over every iteration, of
// the epilogue's store and of the whole block, each summed over the
// blocks, the number of blocks timed, the cycles the blocks waited at
// the segment hand-offs of stages 2 and 3 (cluster kernel only), and the
// number of Quu's pivots whose reciprocal left rcp_rn()'s fast path (a
// count, not cycles; 0 while Quu's diagonal carries 2R + rho > 0).
constexpr int kClkPrologue = 0, kClkLinearize = 1, kClkRiccati = 2, kClkRollout = 3;
constexpr int kClkLineSearch = 4, kClkEpilogue = 5, kClkTotal = 6, kClkBlocks = 7;
constexpr int kClkHandoff = 8, kClkRcpSlow = 9;
constexpr int kClockSlots = 10;

// The alpha slots, the work floats a knot, and the floats a knot and of
// the fixed region, for num_alphas alphas.
struct Layout {
  int slots, work, knot, fixed;
};
__host__ __device__ inline Layout layout(int num_alphas) {
  Layout l;
  l.slots = num_alphas > kAlphaSlots ? num_alphas : kAlphaSlots;
  l.work = 2 * l.slots > kWork ? 2 * l.slots : kWork;
  l.knot = kKnotFloats + l.work - kWork;
  l.fixed = kFixedFloats + l.slots - kAlphaSlots;
  return l;
}

// Dynamic shared memory of a block holding `knots` knots (host side).
inline long long smem_bytes(int knots, int num_alphas) {
  const Layout l = layout(num_alphas);
  return 4LL * (static_cast<long long>(knots) * l.knot + l.fixed);
}

// The block's shared arrays and its part of the horizon: it owns knots
// [lo, hi) of the lane's N, rank `rank` of the lane's `nblk` blocks, each
// holding up to `seg` knots.  Knot k of the segment is slot k - lo of
// each per-knot region (region + (k - lo) * rows).
struct Smem {
  float *X, *U, *G, *da, *minv, *d, *qv, *sc, *J, *K, *kff, *dX, *dU, *work,
      *terms;
  float *S, *SA, *SB, *Qxx, *Qxu, *Quu, *sv, *Sc, *qx, *qu, *merit, *w;
  LaneState* st;
  int slots, kw;  // alpha slots; work floats a knot
  int lo, hi, seg, rank, nblk;
};

DEV Smem carve(float* base, int num_alphas, int seg, int lo, int hi, int rank, int nblk) {
  const Layout l = layout(num_alphas);
  Smem s;
  s.slots = l.slots;
  s.kw = l.work;
  s.lo = lo;
  s.hi = hi;
  s.seg = seg;
  s.rank = rank;
  s.nblk = nblk;
  float* p = base;
  s.st = reinterpret_cast<LaneState*>(p);
  p += kState;
  s.S = p;    p += 144;
  s.SA = p;   p += 144;
  s.SB = p;   p += 72;
  s.Qxx = p;  p += 144;
  s.Qxu = p;  p += 72;
  s.Quu = p;  p += 36;
  s.sv = p;   p += 12;
  s.Sc = p;   p += 12;
  s.qx = p;   p += 12;
  s.qu = p;   p += 6;
  s.merit = p; p += l.slots;
  s.w = p;    p += 6;
  s.X = p;    p += seg * kX;
  s.U = p;    p += seg * kU;
  s.G = p;    p += seg * kG;
  s.da = p;   p += seg * kDa;
  s.minv = p; p += seg * kMinv;
  s.d = p;    p += seg * kD;
  s.qv = p;   p += seg * kQv;
  s.sc = p;   p += seg * kSc;
  s.J = p;    p += seg * kJ;
  s.K = p;    p += seg * kK;
  s.kff = p;  p += seg * kKff;
  s.dX = p;   p += seg * kDX;
  s.dU = p;   p += seg * kDU;
  s.work = p; p += seg * l.work;
  s.terms = p;
  return s;
}

// Knot k of `region` (rows floats a knot): this block's slot if it owns k,
// else the owning block's, over distributed shared memory.
template <bool Cl>
DEV float* knot_at(const Smem& s, float* region, int rows, int k) {
  if constexpr (!Cl) {
    return region + k * rows;
  } else {
    const int q = k / s.seg;
    float* slot = region + (k - q * s.seg) * rows;  // the same slot here
    return q == s.rank ? slot : cg::this_cluster().map_shared_rank(slot, q);
  }
}

// The first slot of `region` in block q's segment: this block's, or block
// q's over distributed shared memory.  A sum over the lane's knots walks
// the segments in order from these.
template <bool Cl>
DEV const float* segment(const Smem& s, float* region, int q) {
  if constexpr (Cl) {
    if (q != s.rank) return cg::this_cluster().map_shared_rank(region, q);
  }
  return region;
}

// With the stage clocks on, thread 0 adds the cycles since the last stage
// boundary to `slot`.  Called right after the barrier that closes the
// stage, so they cover the whole block's (in a cluster, this block's) work
// on it; the last boundary's time waits in shared memory, not in a
// register.
DEV void stage_clock(LaneState* st, unsigned long long* clocks, int slot) {
  if (threadIdx.x == 0 && st->clocks) {
    const unsigned long long t = clock64();
    atomicAdd(clocks + slot, t - st->t_stage);
    st->t_stage = t;
  }
}

// The cluster barrier after a segment of stage 2 or 3.  With the stage
// clocks on, thread 0 adds the cycles it waited there for the other
// blocks to kClkHandoff at once: a sum kept in the lane state, which is
// full, would move every shared array of the one-block kernel too.
DEV void segment_handoff(const LaneState* st, unsigned long long* clocks) {
  const bool timed = threadIdx.x == 0 && st->clocks;
  const unsigned long long t = timed ? clock64() : 0ULL;
  cg::this_cluster().sync();
  if (timed) atomicAdd(clocks + kClkHandoff, clock64() - t);
}

// A barrier over the lane's blocks: the cluster's, or the block's.
template <bool Cl>
DEV void lane_sync() {
  if constexpr (Cl)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// Joint-range barrier at q: value, gradient and GN Hessian diagonal.
DEV float barrier(const ModelConsts& m, const SolveParams& p, const float* q,
                  float* gb, float* hb) {
  float cb = 0.f;
  const float w = p.q_barrier;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const float hi = m.q_upper[i] - p.q_barrier_margin;
    const float lo = m.q_lower[i] + p.q_barrier_margin;
    const float d_hi = fmaxf(q[i] - hi, 0.f);
    const float d_lo = fmaxf(lo - q[i], 0.f);
    cb += w * (d_hi * d_hi + d_lo * d_lo);
    gb[i] = 2.f * w * (d_hi - d_lo);
    hb[i] = 2.f * w * ((d_hi > 0.f || d_lo > 0.f) ? 1.f : 0.f);
  }
  return cb;
}

// Stage 1a, cost item of knot k < N: Gauss-Newton cost data into qv/sc/J,
// and err^2, the barrier value and v^2 into the knot's terms.
DEV void cost_item(const ModelConsts& m, const SolveParams& p, const Smem& s,
                   int k) {
  const int kl = k - s.lo;
  float x[NX], goal[3];
#pragma unroll
  for (int r = 0; r < NX; ++r) x[r] = s.X[kl * kX + r];
#pragma unroll
  for (int r = 0; r < 3; ++r) goal[r] = s.G[kl * kG + r];
  float pe[3], J[3][NJ];
  ee_pos_jacobian(m, x, pe, J);
  float err[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) err[a] = pe[a] - goal[a];
  const float err2 = err[0] * err[0] + err[1] * err[1] + err[2] * err[2];
  const float scale = p.regularize ? 1.f / (sqrtf(err2) + p.eps) : 1.f;
  const float twodQ = 2.f * p.dQ * scale;
  const float twoR = 2.f * p.R * scale;
  float gb[NQ] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float hb[NQ] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float cb = p.q_barrier != 0.f ? barrier(m, p, x, gb, hb) : 0.f;
  float* qv = s.qv + kl * kQv;
  float* sc = s.sc + kl * kSc;
  float* Jk = s.J + kl * kJ;
  float v2 = 0.f;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const float gp = 2.f * (J[0][i] * err[0] + J[1][i] * err[1] + J[2][i] * err[2]);
    qv[i] = gp + gb[i];
    qv[NQ + i] = twodQ * x[NQ + i];
    sc[2 + i] = hb[i];
#pragma unroll
    for (int a = 0; a < 3; ++a) Jk[a * NQ + i] = J[a][i];
    v2 += x[NQ + i] * x[NQ + i];
  }
  sc[0] = twodQ;
  sc[1] = twoR;
  float* t = s.terms + kl * kTerms;
  t[kTErr2] = err2;
  t[kTBar] = cb;
  t[kTV2] = v2;
}

// Stage 1a, dynamics item of knot k < N-1: forward dynamics (a, L, invD
// kept in the knot's work for stage 1b), dt M^-1, the Euler defect, u^2
// and the defect norms.  The joint rotations are formed once, for the
// wrench map and the dynamics.
template <bool Cl>
DEV void dynamics_item(const ModelConsts& m, const SolveParams& p,
                       const Smem& s, int k) {
  const float dt = p.dt;
  const int kl = k - s.lo;
  const float* xk1 = knot_at<Cl>(s, s.X, kX, k + 1);
  float x[NX], u[NU];
#pragma unroll
  for (int r = 0; r < NX; ++r) x[r] = s.X[kl * kX + r];
#pragma unroll
  for (int r = 0; r < NU; ++r) u[r] = s.U[kl * kU + r];
  const float* q = x;
  const float* v = x + NQ;
  float R[NJ][3][3], fl[3], nl[3];
  rotations(m, q, R);
  if (p.use_wrench) {
    float Rw[3][3], pw[3];
    fk_last(m, R, Rw, pw);
    wrench_to_ee(Rw, pw, s.w, fl, nl);
  }
  float a[NJ], L[6][6], invD[6];
  forward_dynamics(m, R, v, u, p.use_wrench, fl, nl, a, L, invD);
  float* wk = s.work + kl * s.kw;
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    wk[i] = a[i];
#pragma unroll
    for (int j = 0; j < i; ++j) wk[6 + i * 6 + j] = L[i][j];
    wk[42 + i] = invD[i];
  }
  // dt * M^-1, row i*6+j = dt * Minv[i][j].
  float* minv = s.minv + kl * kMinv;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    float e[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, col[6];
    e[j] = 1.f;
    ldl6_solve(L, invD, e, col);
#pragma unroll
    for (int i = 0; i < NU; ++i) minv[i * NU + j] = dt * col[i];
  }
  // Euler defect d = [q + dt v; v + dt a] - x_{k+1}, x_{k+1} read only now
  // (not held in registers through the dynamics).
  float dq2 = 0.f, dv2 = 0.f, u2 = 0.f;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const float dq = (q[i] + dt * v[i]) - xk1[i];
    const float dv = (v[i] + dt * a[i]) - xk1[NQ + i];
    s.d[kl * kD + i] = dq;
    s.d[kl * kD + NQ + i] = dv;
    dq2 += dq * dq;
    dv2 += dv * dv;
    u2 += u[i] * u[i];
  }
  float* t = s.terms + kl * kTerms;
  t[kTU2] = u2;
  t[kTCv] = sqrtf(dq2) + sqrtf(dv2);
}

// Stage 1b, item (knot k, tangent t): d RNEA(q, v, a*; f_ext(q)) / dx_t by
// a one-tangent Dual pass, then column t of dt * da = -dt M^-1 dtau.
DEV void tangent_item(const ModelConsts& m, const SolveParams& p,
                      const Smem& s, int k, int t) {
  const int kl = k - s.lo;
  const float* x = s.X + kl * kX;
  const float* wk = s.work + kl * s.kw;
  Dual qd[NQ], vd[NQ], ad[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    qd[i] = Dual(x[i], t == i ? 1.f : 0.f);
    vd[i] = Dual(x[NQ + i], t == NQ + i ? 1.f : 0.f);
    ad[i] = Dual(wk[i]);
  }
  float dtau[NQ];
  rnea_tangent(m, qd, vd, ad, p.use_wrench, s.w, dtau);
  float L[6][6], invD[6], sol[NQ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) L[i][j] = wk[6 + i * 6 + j];
    invD[i] = wk[42 + i];
  }
  ldl6_solve(L, invD, dtau, sol);
  float* da = s.da + kl * kDa;
#pragma unroll
  for (int i = 0; i < NQ; ++i) da[i * NX + t] = p.dt * -sol[i];
}

// Running-knot cost Hessian entry Q[i][j] = [2 qmod J^T J + qmod diag(hb),
// 0; 0, 2dQ I] from the knot's J (18) and sc ([2dQ, 2R, hb]).
DEV float q_entry(const float* J, const float* sc, float qmod, int i, int j) {
  if (i < NQ && j < NQ) {
    const float v = J[i] * (2.f * qmod * J[j]) +
                    J[NQ + i] * (2.f * qmod * J[NQ + j]) +
                    J[2 * NQ + i] * (2.f * qmod * J[2 * NQ + j]);
    return i == j ? v + qmod * sc[2 + j] : v;
  }
  return (i == j && i >= NQ) ? sc[0] : 0.f;
}

// Row i of A^T c for A = I + [0 dt I; dt*da], c a 12-vector with stride cs.
DEV float At_row(const float* dtda, float dt, const float* c, int cs, int i) {
  float o = c[i * cs] + (i >= NQ ? dt * c[(i - NQ) * cs] : 0.f);
  for (int t = 0; t < NQ; ++t) o += dtda[t * NX + i] * c[(NQ + t) * cs];
  return o;
}

// Pair p of the n (n + 1) / 2 pairs i <= j of an n x n symmetric matrix, n
// even: row r of the folded (n / 2) x (n + 1) table holds (r, r..n-1) and
// then (n-1-r, n-1-r..n-1).
template <int n>
DEV void sym_pair(int p, int& i, int& j) {
  const int r = p / (n + 1), c = p - r * (n + 1);
  const bool first = c < n - r;
  i = first ? r : n - 1 - r;
  j = first ? r + c : c - 1;
}

// The three passes of a running knot step, at kMaxThreads threads: each
// kind of entry starts on a warp boundary, the longest chains first.  A
// thread's slot v in a pass is its index in that padded space; with fewer
// threads the block strides over the slots (the holes do nothing), so each
// entry is still formed by one thread with the same operations.
//   A: Quu (21, lower triangle, from S and W), Sc (12), SA by column pairs
//      (j, j + 6) (72), SB (72);
//   B: the LDL^T factor of Quu (thread kBFactor, whose warp has no other
//      slot), Qxx by column pairs (j, j + 6) (72), Qxu by column pairs
//      (j, j + 3) (36), qx (12), qu (6);
//   C: S' by symmetric pairs (78), s (12).
constexpr int kAQuu = 0, kASc = 32, kASA = 64, kASB = 160, kAEnd = 232;
constexpr int kBFactor = 0, kBQxx = 32, kBQxu = 128, kBqx = 192, kBqu = 224, kBEnd = 230;
constexpr int kCS = 0, kCs = 96, kCEnd = 108;

// Quu = L D L^T in place: L below the diagonal, 1/D on it, the pivots'
// reciprocals by rcp_rn().  With the stage clocks on, adds the number of
// pivots whose reciprocal took rcp_rn()'s slow path to kClkRcpSlow.
// Inlined around the compiler's divisions it spilled more of stage 1
// (sqp_kernel<true>: 136 bytes of stack and 80 of spill stores, against
// 112 and 56 out of line); around rcp_rn() it keeps 112 and 56 in line.
DEV void factor_quu(float* F, const LaneState* st, unsigned long long* clocks) {
  float M[6][6], L[6][6], invD[6];
  for (int i = 0; i < NU; ++i)
    for (int j = 0; j <= i; ++j) M[i][j] = F[i * NU + j];
  int slow = 0;
  ldl6(M, L, invD, RcpInline{&slow});
  for (int i = 0; i < NU; ++i) {
    for (int j = 0; j < i; ++j) F[i * NU + j] = L[i][j];
    F[i * NU + i] = invD[i];
  }
  if (slow != 0 && st->clocks)
    atomicAdd(clocks + kClkRcpSlow, static_cast<unsigned long long>(slow));
}

// Stage 2 on the block's segment: the Riccati backward sweep over its
// running knots, from the terminal knot's S and s or from those the next
// block's segment left; stores K and kff per knot.  S is kept symmetric
// where it is written (the terminal S as the cost builds it), so every
// reader loads it as stored.
template <bool Cl>
DEV void sweep_segment(const SolveParams& p, const Smem& s, unsigned long long* clocks) {
  const int N = p.N, Nm1 = N - 1, tid = threadIdx.x, nt = blockDim.x;
  const float dt = p.dt, rho = s.st->rho;
  if (s.hi == N) {
    const float* J = s.J + (N - 1 - s.lo) * kJ;
    const float* sc = s.sc + (N - 1 - s.lo) * kSc;
    const float* qv = s.qv + (N - 1 - s.lo) * kQv;
    for (int e = tid; e < 144 + NX; e += nt) {
      if (e < 144)
        s.S[e] = q_entry(J, sc, p.QN, e / NX, e % NX);
      else
        s.sv[e - 144] = e - 144 < NQ ? p.QN * qv[e - 144] : qv[e - 144];
    }
  } else if constexpr (Cl) {
    cg::cluster_group cl = cg::this_cluster();
    const float* S1 = cl.map_shared_rank(s.S, s.rank + 1);
    const float* sv1 = cl.map_shared_rank(s.sv, s.rank + 1);
    for (int e = tid; e < 144 + NX; e += nt) {
      if (e < 144)
        s.S[e] = S1[e];
      else
        s.sv[e - 144] = sv1[e - 144];
    }
  }
  __syncthreads();
  const float* S = s.S;
  for (int k = min(s.hi, Nm1) - 1; k >= s.lo; --k) {
    const int kl = k - s.lo;
    const float* dtda = s.da + kl * kDa;  // row u*12+j = dt * da[u][j]
    const float* W = s.minv + kl * kMinv;  // row u*6+j = dt * Minv[u][j]
    const float* J = s.J + kl * kJ;
    const float* sc = s.sc + kl * kSc;
    const float twoR = sc[1];
    // Pass A: Quu = B^T S B + (2R + rho) I with B = [0; dt M^-1], its SB
    // rows recomputed; Sc = S d + s; SA = S A with A = I + [0 dt I; dt*da];
    // SB = S B.
    for (int v = tid; v < kAEnd; v += nt) {
      if (v < kASc) {
        if (v - kAQuu < 21) {
          int j, i;  // i >= j
          sym_pair<NU>(v - kAQuu, j, i);
          float sb[NQ];
          for (int t = 0; t < NQ; ++t) {
            float c = 0.f;
            for (int u = 0; u < NQ; ++u) c += S[(NQ + t) * NX + NQ + u] * W[u * NU + j];
            sb[t] = c;
          }
          float q = 0.f;
          for (int t = 0; t < NQ; ++t) q += W[t * NU + i] * sb[t];
          s.Quu[i * NU + j] = i == j ? q + (twoR + rho) : q;
        }
      } else if (v < kASA) {
        const int i = v - kASc;
        if (i < NX) {
          const float* d = s.d + kl * kD;
          float acc = 0.f;
          for (int j = 0; j < NX; ++j) acc += S[i * NX + j] * d[j];
          s.Sc[i] = acc + s.sv[i];
        }
      } else if (v < kASB) {
        const int e = v - kASA;
        if (e < 72) {
          const int r = e / NU, j = e % NU;
          const float* Sr = S + r * NX;
          float c0 = Sr[j], c1 = Sr[NQ + j];
          c1 = c1 + dt * Sr[j];
          for (int u = 0; u < NQ; ++u) {
            c0 += Sr[NQ + u] * dtda[u * NX + j];
            c1 += Sr[NQ + u] * dtda[u * NX + NQ + j];
          }
          s.SA[r * NX + j] = c0;
          s.SA[r * NX + NQ + j] = c1;
        }
      } else {
        const int e = v - kASB, r = e / NU, j = e % NU;
        float c = 0.f;
        for (int u = 0; u < NQ; ++u) c += S[r * NX + NQ + u] * W[u * NU + j];
        s.SB[e] = c;
      }
    }
    __syncthreads();
    // Pass B: the others form Qxx = A^T SA + Q, Qxu = A^T SB, qx = A^T Sc
    // and qu = B^T Sc + 2R u while one thread factors Quu.
    for (int v = tid; v < kBEnd; v += nt) {
      if (v < kBQxx) continue;  // the factor's warp
      if (v < kBQxu) {
        const int e = v - kBQxx;
        if (e < 72) {
          const int i = e / NU, j = e % NU;
          s.Qxx[i * NX + j] = At_row(dtda, dt, s.SA + j, NX, i) + q_entry(J, sc, 1.f, i, j);
          s.Qxx[i * NX + NQ + j] =
              At_row(dtda, dt, s.SA + NQ + j, NX, i) + q_entry(J, sc, 1.f, i, NQ + j);
        }
      } else if (v < kBqx) {
        const int e = v - kBQxu;
        if (e < 36) {
          const int i = e / 3, j = e % 3;
          s.Qxu[i * NU + j] = At_row(dtda, dt, s.SB + j, NU, i);
          s.Qxu[i * NU + 3 + j] = At_row(dtda, dt, s.SB + 3 + j, NU, i);
        }
      } else if (v < kBqu) {
        const int i = v - kBqx;
        if (i < NX) s.qx[i] = At_row(dtda, dt, s.Sc, 1, i);
      } else {
        const int t = v - kBqu;
        float acc = 0.f;
        for (int u = 0; u < NQ; ++u) acc += W[u * NU + t] * s.Sc[NQ + u];
        s.qu[t] = acc + twoR * s.U[kl * kU + t];
      }
    }
    if (tid == kBFactor) factor_quu(s.Quu, s.st, clocks);
    __syncthreads();
    // Pass C: K = -Quu^-1 Qxu^T and kff = -Quu^-1 qu from the factor, each
    // thread solving the columns it needs; S' = Qxx + Qxu K stored
    // symmetrized, 0.5 (S' + S'^T), by the thread that forms both entries of
    // a pair; s = qx + q + Qxu kff.
    for (int v = tid; v < kCEnd; v += nt) {
      float L[6][6], invD[6];
      for (int i = 0; i < NU; ++i) {
        for (int j = 0; j < i; ++j) L[i][j] = s.Quu[i * NU + j];
        invD[i] = s.Quu[i * NU + i];
      }
      if (v < kCs) {
        if (v - kCS < 78) {
          int i, j;  // i <= j
          sym_pair<NX>(v - kCS, i, j);
          float qi[NU], qj[NU], ki[NU], kj[NU];
          for (int t = 0; t < NU; ++t) {
            qi[t] = s.Qxu[i * NU + t];
            qj[t] = s.Qxu[j * NU + t];
          }
          ldl6_solve(L, invD, qj, kj);
          ldl6_solve(L, invD, qi, ki);
          float a = s.Qxx[i * NX + j], b = s.Qxx[j * NX + i];
          for (int t = 0; t < NU; ++t) {
            a += qi[t] * -kj[t];
            b += qj[t] * -ki[t];
          }
          if (i == j) {
            s.S[i * NX + i] = a;
            for (int t = 0; t < NU; ++t) s.K[kl * kK + t * NX + j] = -kj[t];
          } else {
            const float m = 0.5f * (a + b);
            s.S[i * NX + j] = m;
            s.S[j * NX + i] = m;
          }
        }
      } else {
        const int i = v - kCs;
        const float* qv = s.qv + kl * kQv;
        float qu[NU], kff[NU];
        for (int t = 0; t < NU; ++t) qu[t] = s.qu[t];
        ldl6_solve(L, invD, qu, kff);
        float acc = s.qx[i] + qv[i];
        for (int t = 0; t < NU; ++t) acc += s.Qxu[i * NU + t] * -kff[t];
        s.sv[i] = acc;
        if (i == 0)
          for (int t = 0; t < NU; ++t) s.kff[kl * kKff + t] = -kff[t];
      }
    }
    __syncthreads();
  }
}

// Stage 2: the sweep over the lane's segments, last to first, each block
// in its turn (a cluster barrier after each).
template <bool Cl>
DEV void backward_sweep(const SolveParams& p, const Smem& s, unsigned long long* clocks) {
  for (int r = s.nblk - 1; r >= 0; --r) {
    if (r == s.rank) sweep_segment<Cl>(p, s, clocks);
    if constexpr (Cl) segment_handoff(s.st, clocks);
  }
}

// Stage 3 on the block's segment: the forward rollout of the delta policy
// from dx0 = 0, or from the dx after the previous block's segment, which
// that block left in its Sc (free after stage 2); this block leaves the
// dx after its own segment in its Sc.
template <bool Cl>
DEV void rollout_segment(const SolveParams& p, const Smem& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const float dt = p.dt;
  if (s.lo == 0) {
    for (int i = tid; i < NX; i += nt) s.dX[i] = 0.f;
    __syncthreads();
  } else if constexpr (Cl) {
    const float* prev = cg::this_cluster().map_shared_rank(s.Sc, s.rank - 1);
    for (int i = tid; i < NX; i += nt) s.dX[i] = prev[i];
    __syncthreads();
  }
  for (int k = s.lo; k < min(s.hi, p.N - 1); ++k) {
    const int kl = k - s.lo;
    const float* dx = s.dX + kl * kDX;
    float* dx_next = s.dX + (kl + 1) * kDX;
    if constexpr (Cl) {
      if (k + 1 == s.hi) dx_next = s.Sc;
    }
    for (int i = tid; i < NX; i += nt) {
      // du = K dx + kff, the same bits in each of the 12 threads.
      float du[NU];
      for (int t = 0; t < NU; ++t) {
        const float* K = s.K + kl * kK + t * NX;
        float acc = 0.f;
        for (int j = 0; j < NX; ++j) acc += K[j] * dx[j];
        du[t] = acc + s.kff[kl * kKff + t];
      }
      if (i < NU) s.dU[kl * kDU + i] = du[i];
      float dxn;
      if (i < NQ) {
        dxn = dx[i] + dt * dx[NQ + i];
      } else {
        const float* da = s.da + kl * kDa + (i - NQ) * NX;
        const float* W = s.minv + kl * kMinv + (i - NQ) * NU;
        float acc = dx[i];
        for (int j = 0; j < NX; ++j) acc += da[j] * dx[j];
        for (int j = 0; j < NU; ++j) acc += W[j] * du[j];
        dxn = acc;
      }
      dx_next[i] = dxn + s.d[kl * kD + i];
    }
    __syncthreads();
  }
}

// Stage 3: the rollout over the lane's segments, first to last, each block
// in its turn (a cluster barrier after each).
template <bool Cl>
DEV void forward_rollout(const SolveParams& p, const Smem& s, unsigned long long* clocks) {
  for (int r = 0; r < s.nblk; ++r) {
    if (r == s.rank) rollout_segment<Cl>(p, s);
    if constexpr (Cl) segment_handoff(s.st, clocks);
  }
}

// Merit cost of one knot state x with EE position pe: qmod * (err^2 +
// barrier) + dQ v^2.
DEV float merit_knot_cost(const ModelConsts& m, const SolveParams& p,
                          const float* x, const float* pe, const float* goal, float qmod) {
  float pos = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) pos += (pe[a] - goal[a]) * (pe[a] - goal[a]);
  if (p.q_barrier != 0.f) {
    float gb[NQ], hb[NQ];
    pos += barrier(m, p, x, gb, hb);
  }
  float v2 = 0.f;
#pragma unroll
  for (int i = 0; i < NQ; ++i) v2 += x[NQ + i] * x[NQ + i];
  return qmod * pos + p.dQ * v2;
}

// Stage 4, item (knot k, alpha c): the candidate's merit cost and, for a
// running knot, its Euler defect norms under the lane wrench.  The joint
// rotations are formed once, for the EE position, the wrench map and the
// dynamics.
template <bool Cl>
DEV void line_search_item(const ModelConsts& m, const SolveParams& p,
                          const Smem& s, int k, int c) {
  const int Nm1 = p.N - 1, kl = k - s.lo;
  const float alpha = ldexpf(1.f, -c);
  const float* goal = s.G + kl * kG;
  float xc[NX], cost, cv = 0.f;
#pragma unroll
  for (int r = 0; r < NX; ++r) xc[r] = s.X[kl * kX + r] + alpha * s.dX[kl * kDX + r];
  float R[NJ][3][3], Rw[3][3], pe[3];
  rotations(m, xc, R);
  fk_last(m, R, Rw, pe);
  if (k == Nm1) {
    cost = merit_knot_cost(m, p, xc, pe, goal, p.QN);
  } else {
    const float dt = p.dt;
    const float* xk1 = knot_at<Cl>(s, s.X, kX, k + 1);
    const float* dxk1 = knot_at<Cl>(s, s.dX, kDX, k + 1);
    float uc[NU], u2 = 0.f;
#pragma unroll
    for (int r = 0; r < NU; ++r) {
      uc[r] = s.U[kl * kU + r] + alpha * s.dU[kl * kDU + r];
      u2 += uc[r] * uc[r];
    }
    cost = merit_knot_cost(m, p, xc, pe, goal, 1.f) + p.R * u2;
    float fl[3], nl[3], acc[NJ], L[6][6], invD[6];
    if (p.use_wrench) wrench_to_ee(Rw, pe, s.w, fl, nl);
    forward_dynamics(m, R, xc + NQ, uc, p.use_wrench, fl, nl, acc, L, invD);
    // The defect against the candidate's x_{k+1}, formed only now.
    float dq2 = 0.f, dv2 = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float eq = (xc[i] + dt * xc[NQ + i]) - (xk1[i] + alpha * dxk1[i]);
      const float ev = (xc[NQ + i] + dt * acc[i]) - (xk1[NQ + i] + alpha * dxk1[NQ + i]);
      dq2 += eq * eq;
      dv2 += ev * ev;
    }
    cv = sqrtf(dq2) + sqrtf(dv2);
  }
  s.work[kl * s.kw + c] = cost;
  s.work[kl * s.kw + s.slots + c] = cv;
}

// The alpha = 0 merit from stage 1's terms, summed in knot order.
template <bool Cl>
DEV float base_merit(const SolveParams& p, const Smem& s) {
  const int N = p.N, Nm1 = N - 1;
  float cost = 0.f, cv = 0.f, bc_T = 0.f;
  for (int k0 = 0; k0 < N; k0 += s.seg) {
    const float* t = segment<Cl>(s, s.terms, k0 / s.seg);
    for (int k = k0; k < min(k0 + s.seg, N); ++k, t += kTerms) {
      if (k < Nm1) {
        cost += ((t[kTErr2] + p.dQ * t[kTV2]) + p.R * t[kTU2]) + t[kTBar];
        cv += t[kTCv];
      } else {
        bc_T = p.QN * t[kTErr2] + p.dQ * t[kTV2] + p.QN * t[kTBar];
      }
    }
  }
  return (cost + bc_T) + p.merit_mu * cv;
}

// The masked update of the block's segment: X += scale dX over its nx
// floats, U += scale dU over its nu.  Kept out of line: inlined into
// sqp_kernel<true>, ptxas at -O1 and above (CUDA 12.9, sm_90a) emitted
// these two loops so that they wrote past the segment's U, into its goals
// (found on the H100 by dumping the shared arrays after every stage; right
// at -O0, out of line, or with the bounds made opaque).  Out of line, the
// loops' trip counts are not held in registers across the SQP iterations
// either, which spilled them in sqp_kernel<false>.  It takes the four
// arrays, not the Smem: a reference would put the whole Smem in the
// kernel's local memory.
__device__ __noinline__ void update_segment(float* X, const float* dX, float* U,
                                            const float* dU, float scale, int nx, int nu) {
  for (int e = threadIdx.x; e < nx; e += blockDim.x) X[e] += scale * dX[e];
  for (int e = threadIdx.x; e < nu; e += blockDim.x) U[e] += scale * dU[e];
}

template <bool Cl>
__global__ void __launch_bounds__(kMaxThreads)
sqp_kernel(ModelConsts m, SolveParams p, const float* __restrict__ xs,
           const float* __restrict__ goals, const float* __restrict__ X,
           const float* __restrict__ U, const float* __restrict__ w,
           const float* __restrict__ rho_in, float* __restrict__ Xo,
           float* __restrict__ Uo, float* __restrict__ rho_out,
           float* __restrict__ alpha_log, float* __restrict__ step_log,
           const int* __restrict__ clock_on, unsigned long long* __restrict__ clocks) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int B = p.B, N = p.N, Nm1 = N - 1, NA = p.num_alphas;
  const long long nB = B;
  // The lane's blocks: a cluster of nblk, this one its rank-th, owning the
  // knots [lo, hi) (the running knots [lo, hr)); or the block alone.
  int lane = blockIdx.x, rank = 0, nblk = 1;
  if constexpr (Cl) {
    cg::cluster_group cl = cg::this_cluster();
    rank = static_cast<int>(cl.block_rank());
    nblk = static_cast<int>(cl.num_blocks());
    lane = blockIdx.x / nblk;
  }
  const int seg = Cl ? (N + nblk - 1) / nblk : N;
  const int lo = rank * seg, hi = min(lo + seg, N), hr = min(hi, Nm1);
  const Smem s = carve(smem, NA, seg, lo, hi, rank, nblk);
  const bool logs = tid == 0 && rank == 0;  // the thread that writes the lane's outputs
  // The entry time, and thread 0's one read of the stage clocks' word,
  // first used after the gather, so that the gather hides its latency.
  const long long t_entry = clock64();
  const int clocks_on = tid == 0 && clock_on != nullptr ? *clock_on : 0;

  // Gather the segment's trajectory and goals, the lane's wrench (stride B
  // in global).
  for (int e = tid; e < (hi - lo) * kX; e += nt) {
    const long long g = lo * kX + e;
    s.X[e] = g < kX ? xs[g * nB + lane] : X[g * nB + lane];
  }
  for (int e = tid; e < (hr - lo) * kU; e += nt) s.U[e] = U[(lo * kU + e) * nB + lane];
  for (int e = tid; e < (hi - lo) * kG; e += nt) s.G[e] = goals[(lo * kG + e) * nB + lane];
  if (p.use_wrench)
    for (int e = tid; e < 6; e += nt) s.w[e] = w[e * nB + lane];
  if (tid == 0) {
    s.st->rho = rho_in[lane];
    s.st->done = 0;
    s.st->clocks = clocks_on != 0;
    s.st->t_stage = static_cast<unsigned long long>(t_entry);
    s.st->t_entry = static_cast<unsigned int>(t_entry);
  }
  lane_sync<Cl>();
  stage_clock(s.st, clocks, kClkPrologue);

  for (int it = 0; it < p.max_iters; ++it) {
    // ---- Stage 1a: dynamics of knots lo..hr-1, cost data of knots
    // lo..hi-1 ----
    for (int e = tid; e < (hr - lo) + (hi - lo); e += nt) {
      if (e < hr - lo)
        dynamics_item<Cl>(m, p, s, lo + e);
      else
        cost_item(m, p, s, lo + e - (hr - lo));
    }
    lane_sync<Cl>();
    // ---- Stage 1b: the (knot, tangent) pairs; the last thread first sums
    // the alpha = 0 merit ----
    if (tid == nt - 1) s.st->base_merit = base_merit<Cl>(p, s);
    for (int e = tid; e < (hr - lo) * NX; e += nt) tangent_item(m, p, s, lo + e / NX, e % NX);
    __syncthreads();
    stage_clock(s.st, clocks, kClkLinearize);

    if (p.stages >= 2) {
      // ---- Stage 2: Riccati sweep; stage 3: rollout (each ends on a
      // barrier) ----
      backward_sweep<Cl>(p, s, clocks);
      stage_clock(s.st, clocks, kClkRiccati);
      if (p.stages >= 3) {
        forward_rollout<Cl>(p, s, clocks);
        stage_clock(s.st, clocks, kClkRollout);
      }
    }
    if (p.stages < 4) {  // profiling cut: no line search, no update
      if (logs) {
        alpha_log[it * nB + lane] = 0.f;
        step_log[it * nB + lane] = 0.f;
      }
      if constexpr (Cl) cg::this_cluster().sync();
      continue;
    }

    // ---- Stage 4: the (knot, alpha) pairs, then the per-alpha merits and
    // the per-knot step norms ----
    for (int e = tid; e < (hi - lo) * NA; e += nt)
      line_search_item<Cl>(m, p, s, lo + e / NA, e % NA);
    lane_sync<Cl>();
    for (int e = tid; e < NA + (hi - lo); e += nt) {
      if (e < NA) {
        float cost = 0.f, cv = 0.f;
        for (int k0 = 0; k0 < N; k0 += seg) {
          const float* wk = segment<Cl>(s, s.work, k0 / seg) + e;
          for (int k = k0; k < min(k0 + seg, N); ++k, wk += s.kw) {
            cost += wk[0];
            if (k < Nm1) cv += wk[s.slots];
          }
        }
        s.merit[e] = cost + p.merit_mu * cv;
      } else {
        const int kl = e - NA;  // knot lo + kl
        float n2 = 0.f;
        for (int r = 0; r < NX; ++r) n2 += s.dX[kl * kDX + r] * s.dX[kl * kDX + r];
        if (lo + kl < Nm1)
          for (int r = 0; r < NU; ++r) n2 += s.dU[kl * kDU + r] * s.dU[kl * kDU + r];
        s.terms[kl * kTerms + kTNrm2] = n2;
      }
    }
    lane_sync<Cl>();
    if (tid == 0) {
      LaneState& st = *s.st;
      float alpha = 0.f;
      for (int c = NA - 1; c >= 0; --c)
        if (s.merit[c] <= st.base_merit) alpha = ldexpf(1.f, -c);
      const bool done = st.done != 0;
      const bool take = !done && alpha > 0.f;
      const float scale = take ? alpha : 0.f;
      float nrm2 = 0.f;
      for (int k0 = 0; k0 < N; k0 += seg) {
        const float* t = segment<Cl>(s, s.terms, k0 / seg) + kTNrm2;
        for (int k = k0; k < min(k0 + seg, N); ++k, t += kTerms) nrm2 += *t;
      }
      const float step = scale * sqrtf(nrm2);
      if (rank == 0) {
        alpha_log[it * nB + lane] = done ? 0.f : alpha;
        step_log[it * nB + lane] = step;
      }
      const bool rejected = !done && alpha <= 0.f;
      st.rho = fminf(fmaxf(rejected ? st.rho * p.rho_factor : st.rho, p.rho_min),
                     p.rho_max);
      st.done = (done || (take && step < p.step_tol)) ? 1 : 0;
      st.scale = scale;
    }
    __syncthreads();
    const float scale = s.st->scale;
    update_segment(s.X, s.dX, s.U, s.dU, scale, (hi - lo) * kX, (hr - lo) * kU);
    lane_sync<Cl>();
    stage_clock(s.st, clocks, kClkLineSearch);
  }

  // Scatter the segment's result.
  for (int e = tid; e < (hi - lo) * kX; e += nt) Xo[(lo * kX + e) * nB + lane] = s.X[e];
  for (int e = tid; e < (hr - lo) * kU; e += nt) Uo[(lo * kU + e) * nB + lane] = s.U[e];
  if (logs) rho_out[lane] = s.st->rho;
  // No block leaves while another may still read its shared memory.
  if constexpr (Cl) {
    cg::this_cluster().sync();
  } else {
    if (s.st->clocks) __syncthreads();  // the same in every thread: the block's stores timed
  }
  if (tid == 0 && s.st->clocks) {
    const unsigned long long t = clock64();
    atomicAdd(clocks + kClkEpilogue, t - s.st->t_stage);
    atomicAdd(clocks + kClkTotal,
              static_cast<unsigned long long>(static_cast<unsigned int>(t) - s.st->t_entry));
    atomicAdd(clocks + kClkBlocks, 1ULL);
  }
}

}  // namespace indy7

// Lets K1 (the plain or the cluster kernel) take up to kSmemLimit bytes of
// dynamic shared memory on the current device: set once per device, not
// on every launch.
template <bool Cl>
static cudaError_t allow_shared_memory() {
  static std::atomic<unsigned long long> done{0};  // one bit per device < 64
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(indy7::sqp_kernel<Cl>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, indy7::kSmemLimit);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// A launch of the cluster kernel: `blocks` blocks of `threads` threads and
// `bytes` of dynamic shared memory, in clusters of `cluster` blocks.
static cudaLaunchConfig_t cluster_config(int blocks, int threads, long long bytes,
                                         int cluster, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The largest cluster size up to kMaxCluster of which one cluster of K1
// blocks (kMaxThreads threads and kSmemLimit bytes each) can be resident
// on the current device, into *out (1 if none can).  Returns a CUDA error
// code.
extern "C" int indy7_sqp_max_cluster(int* out) {
  cudaError_t err = allow_shared_memory<true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = 1;
  for (int c = indy7::kMaxCluster; c > 1; --c) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(c, indy7::kMaxThreads, indy7::kSmemLimit, c, nullptr, &attr);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, indy7::sqp_kernel<true>, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters > 0) {
      *out = c;
      break;
    }
  }
  return static_cast<int>(cudaSuccess);
}

// Launches K1 on `stream`: per lane one block of `threads` threads (a
// multiple of 32, at most 256), or with `cluster` > 1 a cluster of that
// many blocks, each holding ceil(N / cluster) knots (every block at least
// one).  Returns a CUDA error code.
extern "C" int indy7_sqp_solve(indy7::ModelConsts m, indy7::SolveParams p,
                               const float* xs, const float* goals,
                               const float* X, const float* U, const float* w,
                               const float* rho_in, float* Xo, float* Uo,
                               float* rho_out, float* alpha_log,
                               float* step_log, const int* clock_on,
                               unsigned long long* clocks, int threads, int cluster,
                               void* stream) {
  if (cluster < 1 || cluster > indy7::kMaxCluster || p.N < 2 || p.num_alphas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = (p.N + cluster - 1) / cluster;
  const long long bytes = indy7::smem_bytes(seg, p.num_alphas);
  if (threads < indy7::kWarp || threads > indy7::kMaxThreads ||
      threads % indy7::kWarp != 0 || bytes > indy7::kSmemLimit ||
      (cluster - 1) * seg >= p.N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster == 1) {
    const cudaError_t err = allow_shared_memory<false>();
    if (err != cudaSuccess) return static_cast<int>(err);
    indy7::sqp_kernel<false><<<p.B, threads, bytes, st>>>(m, p, xs, goals, X, U, w, rho_in, Xo, Uo, rho_out, alpha_log, step_log, clock_on, clocks);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = allow_shared_memory<true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(p.B * cluster, threads, bytes, cluster, st, &attr);
  err = cudaLaunchKernelEx(&cfg, indy7::sqp_kernel<true>, m, p, xs, goals, X, U, w, rho_in,
                           Xo, Uo, rho_out, alpha_log, step_log, clock_on, clocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
