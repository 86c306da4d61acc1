// Kernel K1: the whole batched SQP solve, one thread block per lane (sm_90a).
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
// of each knot's products (4 barriers a knot: S is re-symmetrized where it
// is read, and each of the 13 Quu solves factors Quu itself), stage 3 over
// the state rows (1 barrier a knot), stage 4 over (knot, alpha) pairs.
// Every cooperative loop is `for (i = tid; i < n; i += nthreads)` between
// barriers, and every sum is taken by one thread in a fixed order, so the
// result is the same bits for any block size.  No tensor cores: the
// products are 12x12 and the recursion needs full f32.  The Dual RNEA of
// stage 1b takes the 255 registers a thread may have, so 256 threads fill
// an SM's register file: one block per SM, 64 of 132 SMs at B=64.
#include <cuda_runtime.h>

#include <atomic>

#include "rbd.cuh"

namespace indy7 {

// Cost, SQP and horizon settings; mirrored by SolveParams in
// ops/kernels/_abi.py.  `stages` < 4 cuts every iteration after stage 1,
// 2 or 3 (a profiling aid: the outputs are then meaningless).
struct SolveParams {
  float dt, dQ, R, QN, eps, q_barrier, q_barrier_margin;
  float merit_mu, step_tol, rho_min, rho_max, rho_factor;
  int regularize, max_iters, num_alphas, N, B, use_wrench, stages;
};

constexpr int kMaxAlphas = 16;
constexpr int kMaxThreads = 256;
constexpr int kWarp = 32;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use

// Shared floats per knot, region by region (each region holds N knots).
constexpr int kX = 12, kU = 6, kG = 3, kDa = 72, kMinv = 36, kD = 12;
constexpr int kQv = 12, kSc = 8, kJ = 18, kK = 72, kKff = 6, kDX = 12, kDU = 6;
// Work: stage 1's a (6), L (36) and invD (6) of the knot, then stage 4's
// costs and defect norms of the knot's (knot, alpha) pairs.
constexpr int kWork = 48;
// Terms of the knot's merit and step norm, by index.
constexpr int kTerms = 6;
constexpr int kTErr2 = 0, kTBar = 1, kTV2 = 2, kTU2 = 3, kTCv = 4, kTNrm2 = 5;
constexpr int kKnotFloats = 329;
static_assert(kKnotFloats == kX + kU + kG + kDa + kMinv + kD + kQv + kSc + kJ +
                                 kK + kKff + kDX + kDU + kWork + kTerms,
              "kKnotFloats");
static_assert(2 * kMaxAlphas <= kWork, "stage 4 pairs fit the work region");

// Per-lane scalars, in the first floats of the fixed region.
struct LaneState {
  float rho, base_merit, scale;
  int done;
};
constexpr int kState = 4;
// Fixed region: the lane state, S (stored before its symmetrization), SA,
// SB, Qxx, Qxu, Quu, s, Sc, qx, qu, the per-alpha merits and the wrench.
constexpr int kFixedFloats = 684;
static_assert(kFixedFloats ==
                  kState + 4 + 144 * 3 + 72 * 2 + 36 + 12 * 3 + 6 + kMaxAlphas + 6,
              "kFixedFloats");

// Dynamic shared memory for horizon N (host side).
inline long long smem_bytes(int N) {
  return 4LL * (static_cast<long long>(N) * kKnotFloats + kFixedFloats);
}

// The block's shared arrays.  Knot k of a region with `rows` floats per
// knot starts at region + k * rows.
struct Smem {
  float *X, *U, *G, *da, *minv, *d, *qv, *sc, *J, *K, *kff, *dX, *dU, *work,
      *terms;
  float *S, *SA, *SB, *Qxx, *Qxu, *Quu, *sv, *Sc, *qx, *qu, *merit, *w;
  LaneState* st;
};

DEV Smem carve(float* base, int N) {
  Smem s;
  float* p = base;
  s.st = reinterpret_cast<LaneState*>(p);
  p += kState + 4;
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
  s.merit = p; p += kMaxAlphas;
  s.w = p;    p += 6;
  s.X = p;    p += N * kX;
  s.U = p;    p += N * kU;
  s.G = p;    p += N * kG;
  s.da = p;   p += N * kDa;
  s.minv = p; p += N * kMinv;
  s.d = p;    p += N * kD;
  s.qv = p;   p += N * kQv;
  s.sc = p;   p += N * kSc;
  s.J = p;    p += N * kJ;
  s.K = p;    p += N * kK;
  s.kff = p;  p += N * kKff;
  s.dX = p;   p += N * kDX;
  s.dU = p;   p += N * kDU;
  s.work = p; p += N * kWork;
  s.terms = p;
  return s;
}

// Joint-range barrier at q: value, gradient and GN Hessian diagonal.
DEV float barrier(const ModelConsts& m, const SolveParams& p, const float* q,
                  float* gb, float* hb) {
  float cb = 0.f;
  const float w = p.q_barrier;
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
  float x[NX], goal[3];
  for (int r = 0; r < NX; ++r) x[r] = s.X[k * kX + r];
  for (int r = 0; r < 3; ++r) goal[r] = s.G[k * kG + r];
  float pe[3], J[3][NJ];
  ee_pos_jacobian(m, x, pe, J);
  float err[3];
  for (int a = 0; a < 3; ++a) err[a] = pe[a] - goal[a];
  const float err2 = err[0] * err[0] + err[1] * err[1] + err[2] * err[2];
  const float scale = p.regularize ? 1.f / (sqrtf(err2) + p.eps) : 1.f;
  const float twodQ = 2.f * p.dQ * scale;
  const float twoR = 2.f * p.R * scale;
  float gb[NQ] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float hb[NQ] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const float cb = p.q_barrier != 0.f ? barrier(m, p, x, gb, hb) : 0.f;
  float* qv = s.qv + k * kQv;
  float* sc = s.sc + k * kSc;
  float* Jk = s.J + k * kJ;
  float v2 = 0.f;
  for (int i = 0; i < NQ; ++i) {
    const float gp = 2.f * (J[0][i] * err[0] + J[1][i] * err[1] + J[2][i] * err[2]);
    qv[i] = gp + gb[i];
    qv[NQ + i] = twodQ * x[NQ + i];
    sc[2 + i] = hb[i];
    for (int a = 0; a < 3; ++a) Jk[a * NQ + i] = J[a][i];
    v2 += x[NQ + i] * x[NQ + i];
  }
  sc[0] = twodQ;
  sc[1] = twoR;
  float* t = s.terms + k * kTerms;
  t[kTErr2] = err2;
  t[kTBar] = cb;
  t[kTV2] = v2;
}

// Stage 1a, dynamics item of knot k < N-1: forward dynamics (a, L, invD
// kept in the knot's work for stage 1b), dt M^-1, the Euler defect, u^2
// and the defect norms.
DEV void dynamics_item(const ModelConsts& m, const SolveParams& p,
                       const Smem& s, int k) {
  const float dt = p.dt;
  float x[NX], xn[NX], u[NU];
  for (int r = 0; r < NX; ++r) {
    x[r] = s.X[k * kX + r];
    xn[r] = s.X[(k + 1) * kX + r];
  }
  for (int r = 0; r < NU; ++r) u[r] = s.U[k * kU + r];
  const float* q = x;
  const float* v = x + NQ;
  float fl[3], nl[3];
  if (p.use_wrench) world_wrench_to_ee(m, q, s.w, fl, nl);
  float a[NJ], L[6][6], invD[6];
  forward_dynamics(m, q, v, u, p.use_wrench ? fl : nullptr,
                   p.use_wrench ? nl : nullptr, a, L, invD);
  float* wk = s.work + k * kWork;
  for (int i = 0; i < NJ; ++i) {
    wk[i] = a[i];
    for (int j = 0; j < i; ++j) wk[6 + i * 6 + j] = L[i][j];
    wk[42 + i] = invD[i];
  }
  // dt * M^-1, row i*6+j = dt * Minv[i][j].
  float* minv = s.minv + k * kMinv;
  for (int j = 0; j < NU; ++j) {
    float e[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, col[6];
    e[j] = 1.f;
    ldl6_solve(L, invD, e, col);
    for (int i = 0; i < NU; ++i) minv[i * NU + j] = dt * col[i];
  }
  // Euler defect d = [q + dt v; v + dt a] - x_{k+1}.
  float dq2 = 0.f, dv2 = 0.f, u2 = 0.f;
  for (int i = 0; i < NQ; ++i) {
    const float dq = (q[i] + dt * v[i]) - xn[i];
    const float dv = (v[i] + dt * a[i]) - xn[NQ + i];
    s.d[k * kD + i] = dq;
    s.d[k * kD + NQ + i] = dv;
    dq2 += dq * dq;
    dv2 += dv * dv;
    u2 += u[i] * u[i];
  }
  float* t = s.terms + k * kTerms;
  t[kTU2] = u2;
  t[kTCv] = sqrtf(dq2) + sqrtf(dv2);
}

// Stage 1b, item (knot k, tangent t): d RNEA(q, v, a*; f_ext(q)) / dx_t by
// a one-tangent Dual pass, then column t of dt * da = -dt M^-1 dtau.
DEV void tangent_item(const ModelConsts& m, const SolveParams& p,
                      const Smem& s, int k, int t) {
  const float* x = s.X + k * kX;
  const float* wk = s.work + k * kWork;
  Dual qd[NQ], vd[NQ], ad[NQ], taud[NQ], fld[3], nld[3];
  for (int i = 0; i < NQ; ++i) {
    qd[i] = Dual(x[i], t == i ? 1.f : 0.f);
    vd[i] = Dual(x[NQ + i], t == NQ + i ? 1.f : 0.f);
    ad[i] = Dual(wk[i]);
  }
  if (p.use_wrench) world_wrench_to_ee(m, qd, s.w, fld, nld);
  rnea(m, qd, vd, ad, p.use_wrench ? fld : nullptr,
       p.use_wrench ? nld : nullptr, taud);
  float L[6][6], invD[6], dtau[NQ], sol[NQ];
  for (int i = 0; i < NJ; ++i) {
    for (int j = 0; j < i; ++j) L[i][j] = wk[6 + i * 6 + j];
    invD[i] = wk[42 + i];
    dtau[i] = taud[i].d;
  }
  ldl6_solve(L, invD, dtau, sol);
  float* da = s.da + k * kDa;
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

// Entry (i, j) of S = 0.5 (S' + S'^T), the re-symmetrized S, from the last
// knot's S'; the terminal S (`raw`) is read as it is stored.
DEV float sym(const float* S, bool raw, int i, int j) {
  return (raw || i == j) ? S[i * NX + j] : 0.5f * (S[i * NX + j] + S[j * NX + i]);
}

// Row i of A^T c for A = I + [0 dt I; dt*da], c a 12-vector with stride cs.
DEV float At_row(const float* dtda, float dt, const float* c, int cs, int i) {
  float o = c[i * cs] + (i >= NQ ? dt * c[(i - NQ) * cs] : 0.f);
  for (int t = 0; t < NQ; ++t) o += dtda[t * NX + i] * c[(NQ + t) * cs];
  return o;
}

// Stage 2: the Riccati backward sweep; stores K and kff per knot.
DEV void backward_sweep(const SolveParams& p, const Smem& s) {
  const int N = p.N, Nm1 = N - 1, tid = threadIdx.x, nt = blockDim.x;
  const float dt = p.dt, rho = s.st->rho;
  {
    const float* J = s.J + (N - 1) * kJ;
    const float* sc = s.sc + (N - 1) * kSc;
    const float* qv = s.qv + (N - 1) * kQv;
    for (int e = tid; e < 144 + NX; e += nt) {
      if (e < 144)
        s.S[e] = q_entry(J, sc, p.QN, e / NX, e % NX);
      else
        s.sv[e - 144] = e - 144 < NQ ? p.QN * qv[e - 144] : qv[e - 144];
    }
  }
  __syncthreads();
  for (int k = Nm1 - 1; k >= 0; --k) {
    const float* dtda = s.da + k * kDa;  // row u*12+j = dt * da[u][j]
    const float* W = s.minv + k * kMinv;  // row u*6+j = dt * Minv[u][j]
    const float* S = s.S;
    const bool raw = k == Nm1 - 1;
    // SA = S A (144), SB = S B with B = [0; dt M^-1] (72), Sc = S d + s (12).
    for (int e = tid; e < 228; e += nt) {
      if (e < 144) {
        const int r = e / NX, j = e % NX;
        float c = sym(S, raw, r, j);
        if (j >= NQ) c = c + dt * sym(S, raw, r, j - NQ);
        for (int u = 0; u < NQ; ++u) c += sym(S, raw, r, NQ + u) * dtda[u * NX + j];
        s.SA[e] = c;
      } else if (e < 216) {
        const int r = (e - 144) / NU, j = (e - 144) % NU;
        float c = 0.f;
        for (int u = 0; u < NQ; ++u) c += sym(S, raw, r, NQ + u) * W[u * NU + j];
        s.SB[e - 144] = c;
      } else {
        const int i = e - 216;
        const float* d = s.d + k * kD;
        float acc = 0.f;
        for (int j = 0; j < NX; ++j) acc += sym(S, raw, i, j) * d[j];
        s.Sc[i] = acc + s.sv[i];
      }
    }
    __syncthreads();
    // Qxx = A^T SA + Q (144), Qxu = A^T SB (72), Quu = B^T SB + (2R + rho) I
    // (lower triangle, 21), qx = A^T Sc (12), qu = B^T Sc + 2R u (6).
    {
      const float* J = s.J + k * kJ;
      const float* sc = s.sc + k * kSc;
      const float twoR = sc[1];
      for (int e = tid; e < 255; e += nt) {
        if (e < 144) {
          const int i = e / NX, j = e % NX;
          s.Qxx[e] = At_row(dtda, dt, s.SA + j, NX, i) + q_entry(J, sc, 1.f, i, j);
        } else if (e < 216) {
          const int i = (e - 144) / NU, j = (e - 144) % NU;
          s.Qxu[e - 144] = At_row(dtda, dt, s.SB + j, NU, i);
        } else if (e < 237) {
          int i = 0, r = e - 216;
          while (r > i) r -= ++i;  // (i, j = r), j <= i, row-major lower
          const int j = r;
          float v = 0.f;
          for (int t = 0; t < NQ; ++t) v += W[t * NU + i] * s.SB[(NQ + t) * NU + j];
          s.Quu[i * NU + j] = i == j ? v + (twoR + rho) : v;
        } else if (e < 249) {
          const int i = e - 237;
          s.qx[i] = At_row(dtda, dt, s.Sc, 1, i);
        } else {
          const int t = e - 249;
          float acc = 0.f;
          for (int u = 0; u < NQ; ++u) acc += W[u * NU + t] * s.Sc[NQ + u];
          s.qu[t] = acc + twoR * s.U[k * kU + t];
        }
      }
    }
    __syncthreads();
    // K = -Quu^-1 Qxu^T (12 columns), kff = -Quu^-1 qu: each of the 13
    // solves factors Quu itself (the same bits in every thread).
    for (int e = tid; e < NX + 1; e += nt) {
      float M[6][6], L[6][6], invD[6], rhs[NU], sol[NU];
      for (int i = 0; i < NU; ++i)
        for (int j = 0; j <= i; ++j) M[i][j] = s.Quu[i * NU + j];
      ldl6(M, L, invD);
      for (int t = 0; t < NU; ++t) rhs[t] = e < NX ? s.Qxu[e * NU + t] : s.qu[t];
      ldl6_solve(L, invD, rhs, sol);
      if (e < NX)
        for (int t = 0; t < NU; ++t) s.K[k * kK + t * NX + e] = -sol[t];
      else
        for (int t = 0; t < NU; ++t) s.kff[k * kKff + t] = -sol[t];
    }
    __syncthreads();
    // S' = Qxx + Qxu K (144), symmetrized where the next knot reads it;
    // s = qx + q + Qxu kff (12).
    {
      const float* K = s.K + k * kK;
      const float* kff = s.kff + k * kKff;
      const float* qv = s.qv + k * kQv;
      for (int e = tid; e < 144 + NX; e += nt) {
        if (e < 144) {
          const int i = e / NX, j = e % NX;
          float acc = s.Qxx[e];
          for (int t = 0; t < NU; ++t) acc += s.Qxu[i * NU + t] * K[t * NX + j];
          s.S[e] = acc;
        } else {
          const int i = e - 144;
          float acc = s.qx[i] + qv[i];
          for (int t = 0; t < NU; ++t) acc += s.Qxu[i * NU + t] * kff[t];
          s.sv[i] = acc;
        }
      }
    }
    __syncthreads();
  }
}

// Stage 3: forward rollout of the delta policy from dx0 = 0.
DEV void forward_rollout(const SolveParams& p, const Smem& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const float dt = p.dt;
  for (int i = tid; i < NX; i += nt) s.dX[i] = 0.f;
  __syncthreads();
  for (int k = 0; k < p.N - 1; ++k) {
    const float* dx = s.dX + k * kDX;
    for (int i = tid; i < NX; i += nt) {
      // du = K dx + kff, the same bits in each of the 12 threads.
      float du[NU];
      for (int t = 0; t < NU; ++t) {
        const float* K = s.K + k * kK + t * NX;
        float acc = 0.f;
        for (int j = 0; j < NX; ++j) acc += K[j] * dx[j];
        du[t] = acc + s.kff[k * kKff + t];
      }
      if (i < NU) s.dU[k * kDU + i] = du[i];
      float dxn;
      if (i < NQ) {
        dxn = dx[i] + dt * dx[NQ + i];
      } else {
        const float* da = s.da + k * kDa + (i - NQ) * NX;
        const float* W = s.minv + k * kMinv + (i - NQ) * NU;
        float acc = dx[i];
        for (int j = 0; j < NX; ++j) acc += da[j] * dx[j];
        for (int j = 0; j < NU; ++j) acc += W[j] * du[j];
        dxn = acc;
      }
      s.dX[(k + 1) * kDX + i] = dxn + s.d[k * kD + i];
    }
    __syncthreads();
  }
}

// Merit cost of one knot state: qmod * (err^2 + barrier) + dQ v^2.
DEV float merit_knot_cost(const ModelConsts& m, const SolveParams& p,
                          const float* x, const float* goal, float qmod) {
  float pe[3];
  ee_pos(m, x, pe);
  float pos = 0.f;
  for (int a = 0; a < 3; ++a) pos += (pe[a] - goal[a]) * (pe[a] - goal[a]);
  if (p.q_barrier != 0.f) {
    float gb[NQ], hb[NQ];
    pos += barrier(m, p, x, gb, hb);
  }
  float v2 = 0.f;
  for (int i = 0; i < NQ; ++i) v2 += x[NQ + i] * x[NQ + i];
  return qmod * pos + p.dQ * v2;
}

// Stage 4, item (knot k, alpha c): the candidate's merit cost and, for a
// running knot, its Euler defect norms under the lane wrench.
DEV void line_search_item(const ModelConsts& m, const SolveParams& p,
                          const Smem& s, int k, int c) {
  const int Nm1 = p.N - 1;
  const float alpha = ldexpf(1.f, -c);
  const float* goal = s.G + k * kG;
  float xc[NX], cost, cv = 0.f;
  for (int r = 0; r < NX; ++r) xc[r] = s.X[k * kX + r] + alpha * s.dX[k * kDX + r];
  if (k == Nm1) {
    cost = merit_knot_cost(m, p, xc, goal, p.QN);
  } else {
    const float dt = p.dt;
    float xnc[NX], uc[NU], u2 = 0.f;
    for (int r = 0; r < NX; ++r)
      xnc[r] = s.X[(k + 1) * kX + r] + alpha * s.dX[(k + 1) * kDX + r];
    for (int r = 0; r < NU; ++r) {
      uc[r] = s.U[k * kU + r] + alpha * s.dU[k * kDU + r];
      u2 += uc[r] * uc[r];
    }
    cost = merit_knot_cost(m, p, xc, goal, 1.f) + p.R * u2;
    float fl[3], nl[3], acc[NJ], L[6][6], invD[6];
    if (p.use_wrench) world_wrench_to_ee(m, xc, s.w, fl, nl);
    forward_dynamics(m, xc, xc + NQ, uc, p.use_wrench ? fl : nullptr,
                     p.use_wrench ? nl : nullptr, acc, L, invD);
    float dq2 = 0.f, dv2 = 0.f;
    for (int i = 0; i < NQ; ++i) {
      const float eq = (xc[i] + dt * xc[NQ + i]) - xnc[i];
      const float ev = (xc[NQ + i] + dt * acc[i]) - xnc[NQ + i];
      dq2 += eq * eq;
      dv2 += ev * ev;
    }
    cv = sqrtf(dq2) + sqrtf(dv2);
  }
  s.work[k * kWork + c] = cost;
  s.work[k * kWork + kMaxAlphas + c] = cv;
}

// The alpha = 0 merit from stage 1's terms, summed in knot order.
DEV float base_merit(const SolveParams& p, const Smem& s) {
  const int Nm1 = p.N - 1;
  float cost = 0.f, cv = 0.f;
  for (int k = 0; k < Nm1; ++k) {
    const float* t = s.terms + k * kTerms;
    cost += ((t[kTErr2] + p.dQ * t[kTV2]) + p.R * t[kTU2]) + t[kTBar];
    cv += t[kTCv];
  }
  const float* t = s.terms + Nm1 * kTerms;
  const float bc_T = p.QN * t[kTErr2] + p.dQ * t[kTV2] + p.QN * t[kTBar];
  return (cost + bc_T) + p.merit_mu * cv;
}

__global__ void __launch_bounds__(kMaxThreads)
sqp_kernel(ModelConsts m, SolveParams p, const float* __restrict__ xs,
           const float* __restrict__ goals, const float* __restrict__ X,
           const float* __restrict__ U, const float* __restrict__ w,
           const float* __restrict__ rho_in, float* __restrict__ Xo,
           float* __restrict__ Uo, float* __restrict__ rho_out,
           float* __restrict__ alpha_log, float* __restrict__ step_log) {
  extern __shared__ float smem[];
  const int lane = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int B = p.B, N = p.N, Nm1 = N - 1, NA = p.num_alphas;
  const long long nB = B;
  const Smem s = carve(smem, N);

  // Gather the lane's trajectory, goals and wrench (stride B in global).
  for (int e = tid; e < N * kX; e += nt)
    s.X[e] = e < kX ? xs[e * nB + lane] : X[e * nB + lane];
  for (int e = tid; e < Nm1 * kU; e += nt) s.U[e] = U[e * nB + lane];
  for (int e = tid; e < N * kG; e += nt) s.G[e] = goals[e * nB + lane];
  if (p.use_wrench)
    for (int e = tid; e < 6; e += nt) s.w[e] = w[e * nB + lane];
  if (tid == 0) {
    s.st->rho = rho_in[lane];
    s.st->done = 0;
  }
  __syncthreads();

  for (int it = 0; it < p.max_iters; ++it) {
    // ---- Stage 1a: dynamics of knots 0..N-2, cost data of knots 0..N-1 ----
    for (int e = tid; e < Nm1 + N; e += nt) {
      if (e < Nm1)
        dynamics_item(m, p, s, e);
      else
        cost_item(m, p, s, e - Nm1);
    }
    __syncthreads();
    // ---- Stage 1b: the (knot, tangent) pairs; the last thread first sums
    // the alpha = 0 merit ----
    if (tid == nt - 1) s.st->base_merit = base_merit(p, s);
    for (int e = tid; e < Nm1 * NX; e += nt) tangent_item(m, p, s, e / NX, e % NX);
    __syncthreads();

    if (p.stages >= 2) {
      // ---- Stage 2: Riccati sweep; stage 3: rollout (each ends on a
      // barrier) ----
      backward_sweep(p, s);
      if (p.stages >= 3) forward_rollout(p, s);
    }
    if (p.stages < 4) {  // profiling cut: no line search, no update
      if (tid == 0) {
        alpha_log[it * nB + lane] = 0.f;
        step_log[it * nB + lane] = 0.f;
      }
      continue;
    }

    // ---- Stage 4: the (knot, alpha) pairs, then the per-alpha merits and
    // the per-knot step norms ----
    for (int e = tid; e < N * NA; e += nt) line_search_item(m, p, s, e / NA, e % NA);
    __syncthreads();
    for (int e = tid; e < NA + N; e += nt) {
      if (e < NA) {
        float cost = 0.f, cv = 0.f;
        for (int k = 0; k < Nm1; ++k) {
          cost += s.work[k * kWork + e];
          cv += s.work[k * kWork + kMaxAlphas + e];
        }
        cost += s.work[Nm1 * kWork + e];
        s.merit[e] = cost + p.merit_mu * cv;
      } else {
        const int k = e - NA;
        float n2 = 0.f;
        for (int r = 0; r < NX; ++r) n2 += s.dX[k * kDX + r] * s.dX[k * kDX + r];
        if (k < Nm1)
          for (int r = 0; r < NU; ++r) n2 += s.dU[k * kDU + r] * s.dU[k * kDU + r];
        s.terms[k * kTerms + kTNrm2] = n2;
      }
    }
    __syncthreads();
    if (tid == 0) {
      LaneState& st = *s.st;
      float alpha = 0.f;
      for (int c = NA - 1; c >= 0; --c)
        if (s.merit[c] <= st.base_merit) alpha = ldexpf(1.f, -c);
      const bool done = st.done != 0;
      const bool take = !done && alpha > 0.f;
      const float scale = take ? alpha : 0.f;
      float nrm2 = 0.f;
      for (int k = 0; k < N; ++k) nrm2 += s.terms[k * kTerms + kTNrm2];
      const float step = scale * sqrtf(nrm2);
      alpha_log[it * nB + lane] = done ? 0.f : alpha;
      step_log[it * nB + lane] = step;
      const bool rejected = !done && alpha <= 0.f;
      st.rho = fminf(fmaxf(rejected ? st.rho * p.rho_factor : st.rho, p.rho_min),
                     p.rho_max);
      st.done = (done || (take && step < p.step_tol)) ? 1 : 0;
      st.scale = scale;
    }
    __syncthreads();
    const float scale = s.st->scale;
    for (int e = tid; e < N * kX; e += nt) s.X[e] += scale * s.dX[e];
    for (int e = tid; e < Nm1 * kU; e += nt) s.U[e] += scale * s.dU[e];
    __syncthreads();
  }

  // Scatter the lane's result.
  for (int e = tid; e < N * kX; e += nt) Xo[e * nB + lane] = s.X[e];
  for (int e = tid; e < Nm1 * kU; e += nt) Uo[e * nB + lane] = s.U[e];
  if (tid == 0) rho_out[lane] = s.st->rho;
}

}  // namespace indy7

// Lets K1 take up to kSmemLimit bytes of dynamic shared memory on the
// current device: set once per device, not on every launch.
static cudaError_t allow_shared_memory() {
  static std::atomic<unsigned long long> done{0};  // one bit per device < 64
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(indy7::sqp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             indy7::kSmemLimit);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// Launches K1 on `stream`, one block of `threads` threads per lane (a
// multiple of 32, at most 256).  Returns a CUDA error code.
extern "C" int indy7_sqp_solve(indy7::ModelConsts m, indy7::SolveParams p,
                               const float* xs, const float* goals,
                               const float* X, const float* U, const float* w,
                               const float* rho_in, float* Xo, float* Uo,
                               float* rho_out, float* alpha_log,
                               float* step_log, int threads, void* stream) {
  const long long bytes = indy7::smem_bytes(p.N);
  if (threads < indy7::kWarp || threads > indy7::kMaxThreads ||
      threads % indy7::kWarp != 0 || bytes > indy7::kSmemLimit ||
      p.num_alphas > indy7::kMaxAlphas)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  indy7::sqp_kernel<<<p.B, threads, bytes, static_cast<cudaStream_t>(stream)>>>(m, p, xs, goals, X, U, w, rho_in, Xo, Uo, rho_out, alpha_log, step_log);
  return static_cast<int>(cudaGetLastError());
}
