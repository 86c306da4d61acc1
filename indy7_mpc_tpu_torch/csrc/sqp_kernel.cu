// Kernel K1: the whole batched SQP solve, one thread per lane (sm_90a).
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
// What bounds it on the card: latency.  One thread per lane with B = 64
// fills two warps on two SMs of 132; each thread runs a long dependent
// chain of scalar float math (~10^7 instructions per solve at N = 64), and
// the per-knot scratch (254 floats per knot per lane, ~65 KB per lane at
// N = 64, 4 MB at B = 64) lives in global memory in (knot, row, lane)
// order, so a warp's accesses coalesce and the working set stays in L2.
// This first version is the simple, correct one; spreading a lane's knots
// (stages 1 and 4) and the 12 columns of S (stage 2) over the threads of a
// block is the next step.
#include <cuda_runtime.h>

#include "rbd.cuh"

namespace indy7 {

// Cost, SQP and horizon settings; mirrored by SolveParams in
// ops/kernels/_abi.py.
struct SolveParams {
  float dt, dQ, R, QN, eps, q_barrier, q_barrier_margin;
  float merit_mu, step_tol, rho_min, rho_max, rho_factor;
  int regularize, max_iters, num_alphas, N, B, use_wrench;
};

constexpr int kMaxAlphas = 16;
constexpr int kThreads = 32;

// Scratch rows per knot, in the order of the regions below.
constexpr int kDa = 72, kMinv = 36, kD = 12, kQv = 12, kSc = 8, kJ = 18;
constexpr int kK = 72, kKff = 6, kDX = 12, kDU = 6;

struct Scratch {
  float *da, *minv, *d, *qv, *sc, *J, *K, *kff, *dX, *dU;
  int B, lane;
  // Element (knot k, row r) of a region with `rows` rows per knot.
  DEV float& at(float* region, int rows, int k, int r) const {
    return region[(static_cast<long long>(k) * rows + r) * B + lane];
  }
};

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

// Gauss-Newton cost data of one knot, stored into qv/sc/J at knot k.
// Returns err^2 and (via cb) the barrier value, for the base merit.
DEV float cost_data(const ModelConsts& m, const SolveParams& p,
                    const Scratch& s, int k, const float* x,
                    const float* goal, float* cb) {
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
  *cb = p.q_barrier != 0.f ? barrier(m, p, x, gb, hb) : 0.f;
  for (int i = 0; i < NQ; ++i) {
    const float gp = 2.f * (J[0][i] * err[0] + J[1][i] * err[1] + J[2][i] * err[2]);
    s.at(s.qv, kQv, k, i) = gp + gb[i];
    s.at(s.qv, kQv, k, NQ + i) = twodQ * x[NQ + i];
    s.at(s.sc, kSc, k, 2 + i) = hb[i];
    for (int a = 0; a < 3; ++a) s.at(s.J, kJ, k, a * NQ + i) = J[a][i];
  }
  s.at(s.sc, kSc, k, 0) = twodQ;
  s.at(s.sc, kSc, k, 1) = twoR;
  return err2;
}

// Stage 1 at a running knot: dynamics linearization, defect and cost data.
// Returns the knot's alpha = 0 merit cost; adds its defect norms to *cv.
DEV float linearize_knot(const ModelConsts& m, const SolveParams& p,
                         const Scratch& s, int k, const float* x,
                         const float* u, const float* xn, const float* w,
                         const float* goal, float* cv) {
  const float dt = p.dt;
  const float* q = x;
  const float* v = x + NQ;
  float fl[3], nl[3];
  if (w != nullptr) world_wrench_to_ee(m, q, w, fl, nl);
  const float* flp = w != nullptr ? fl : nullptr;
  const float* nlp = w != nullptr ? nl : nullptr;
  float a[NJ], L[6][6], invD[6];
  forward_dynamics(m, q, v, u, flp, nlp, a, L, invD);

  // dt * M^-1 (da/du), row i*6+j = dt * Minv[i][j].
  for (int j = 0; j < NU; ++j) {
    float e[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, col[6];
    e[j] = 1.f;
    ldl6_solve(L, invD, e, col);
    for (int i = 0; i < NU; ++i) s.at(s.minv, kMinv, k, i * NU + j) = dt * col[i];
  }

  // dt * da/dx, row i*12+t: d RNEA(q, v, a*; f_ext(q)) / dx_t by a Dual
  // pass, then da = -M^-1 dtau.
  for (int t = 0; t < NX; ++t) {
    Dual qd[NQ], vd[NQ], ad[NQ], taud[NQ], fld[3], nld[3];
    for (int i = 0; i < NQ; ++i) {
      qd[i] = Dual(q[i], t == i ? 1.f : 0.f);
      vd[i] = Dual(v[i], t == NQ + i ? 1.f : 0.f);
      ad[i] = Dual(a[i]);
    }
    if (w != nullptr) world_wrench_to_ee(m, qd, w, fld, nld);
    rnea(m, qd, vd, ad, w != nullptr ? fld : nullptr,
         w != nullptr ? nld : nullptr, taud);
    float dtau[NQ], sol[NQ];
    for (int i = 0; i < NQ; ++i) dtau[i] = taud[i].d;
    ldl6_solve(L, invD, dtau, sol);
    for (int i = 0; i < NQ; ++i) s.at(s.da, kDa, k, i * NX + t) = dt * -sol[i];
  }

  // Euler defect d = [q + dt v; v + dt a] - x_{k+1}.
  float dq2 = 0.f, dv2 = 0.f;
  for (int i = 0; i < NQ; ++i) {
    const float dq = (q[i] + dt * v[i]) - xn[i];
    const float dv = (v[i] + dt * a[i]) - xn[NQ + i];
    s.at(s.d, kD, k, i) = dq;
    s.at(s.d, kD, k, NQ + i) = dv;
    dq2 += dq * dq;
    dv2 += dv * dv;
  }
  *cv += sqrtf(dq2) + sqrtf(dv2);

  float cb;
  const float err2 = cost_data(m, p, s, k, x, goal, &cb);
  float v2 = 0.f, u2 = 0.f;
  for (int i = 0; i < NQ; ++i) {
    v2 += v[i] * v[i];
    u2 += u[i] * u[i];
  }
  return (err2 + p.dQ * v2) + p.R * u2 + cb;
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

// (A^T c)[i] for A = I + [0 dt I; dt*da]: c (12) in, out (12).
DEV void At_apply(const float (*dtda)[NX], float dt, const float* c, float* out) {
  for (int i = 0; i < NX; ++i) {
    float o = c[i] + (i >= NQ ? dt * c[i - NQ] : 0.f);
    for (int t = 0; t < NQ; ++t) o += dtda[t][i] * c[NQ + t];
    out[i] = o;
  }
}

// Running-knot cost Hessian Q = [2 qmod J^T J + qmod diag(hb), 0; 0, 2dQ I].
DEV float q_entry(const float (*J)[NJ], const float* hb, float twodQ,
                  float qmod, int i, int j) {
  if (i < NQ && j < NQ) {
    float v = J[0][i] * (2.f * qmod * J[0][j]) + J[1][i] * (2.f * qmod * J[1][j]) +
              J[2][i] * (2.f * qmod * J[2][j]);
    return i == j ? v + qmod * hb[j] : v;
  }
  return (i == j && i >= NQ) ? twodQ : 0.f;
}

DEV void load_cost_hessian(const Scratch& s, int k, float (*J)[NJ], float* hb,
                           float* twodQ, float* twoR) {
  for (int a = 0; a < 3; ++a)
    for (int i = 0; i < NQ; ++i) J[a][i] = s.at(s.J, kJ, k, a * NQ + i);
  for (int i = 0; i < NQ; ++i) hb[i] = s.at(s.sc, kSc, k, 2 + i);
  *twodQ = s.at(s.sc, kSc, k, 0);
  *twoR = s.at(s.sc, kSc, k, 1);
}

// Stage 2: the Riccati backward sweep; stores K and kff per knot.
DEV void backward_sweep(const SolveParams& p, const Scratch& s, float rho,
                        const float* Uo, int lane) {
  const int N = p.N, Nm1 = N - 1, B = p.B;
  const float dt = p.dt, QN = p.QN;
  float S[NX][NX], sv[NX];
  {
    float J[3][NJ], hb[NQ], twodQ, twoR;
    load_cost_hessian(s, N - 1, J, hb, &twodQ, &twoR);
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) S[i][j] = q_entry(J, hb, twodQ, QN, i, j);
    for (int i = 0; i < NQ; ++i) {
      sv[i] = QN * s.at(s.qv, kQv, N - 1, i);
      sv[NQ + i] = s.at(s.qv, kQv, N - 1, NQ + i);
    }
  }
  for (int k = Nm1 - 1; k >= 0; --k) {
    float dtda[NQ][NX], W[NQ][NU], d[NX];
    for (int i = 0; i < NQ; ++i) {
      for (int j = 0; j < NX; ++j) dtda[i][j] = s.at(s.da, kDa, k, i * NX + j);
      for (int j = 0; j < NU; ++j) W[i][j] = s.at(s.minv, kMinv, k, i * NU + j);
    }
    for (int i = 0; i < NX; ++i) d[i] = s.at(s.d, kD, k, i);
    float J[3][NJ], hb[NQ], twodQ, twoR;
    load_cost_hessian(s, k, J, hb, &twodQ, &twoR);

    // Sc = S d + s.
    float Sc[NX];
    for (int i = 0; i < NX; ++i) {
      float acc = 0.f;
      for (int j = 0; j < NX; ++j) acc += S[i][j] * d[j];
      Sc[i] = acc + sv[i];
    }
    // Qxx = A^T (S A) + Q, column by column.
    float Qxx[NX][NX];
    for (int j = 0; j < NX; ++j) {
      float col[NX], out[NX];
      for (int r = 0; r < NX; ++r) {
        float c = j < NQ ? S[r][j] : S[r][j] + dt * S[r][j - NQ];
        for (int u = 0; u < NQ; ++u) c += S[r][NQ + u] * dtda[u][j];
        col[r] = c;
      }
      At_apply(dtda, dt, col, out);
      for (int i = 0; i < NX; ++i) Qxx[i][j] = out[i] + q_entry(J, hb, twodQ, 1.f, i, j);
    }
    // SB = S B (B = [0; dt M^-1]) and Qxu = A^T S B.
    float SB[NX][NU], Qxu[NX][NU];
    for (int j = 0; j < NU; ++j) {
      float col[NX], out[NX];
      for (int r = 0; r < NX; ++r) {
        float c = 0.f;
        for (int u = 0; u < NQ; ++u) c += S[r][NQ + u] * W[u][j];
        col[r] = c;
        SB[r][j] = c;
      }
      At_apply(dtda, dt, col, out);
      for (int i = 0; i < NX; ++i) Qxu[i][j] = out[i];
    }
    // Quu = B^T S B + (2R + rho) I (lower triangle, mirrored).
    float Quu[NU][NU];
    for (int i = 0; i < NU; ++i)
      for (int j = 0; j <= i; ++j) {
        float v = 0.f;
        for (int t = 0; t < NQ; ++t) v += W[t][i] * SB[NQ + t][j];
        Quu[i][j] = i == j ? v + (twoR + rho) : v;
        Quu[j][i] = Quu[i][j];
      }
    float L[6][6], invD[6];
    ldl6(Quu, L, invD);

    // K = -Quu^-1 Qxu^T, kff = -Quu^-1 (B^T Sc + 2R u).
    float K[NU][NX], kff[NU];
    for (int j = 0; j < NX; ++j) {
      float sol[NU];
      ldl6_solve(L, invD, Qxu[j], sol);
      for (int t = 0; t < NU; ++t) K[t][j] = -sol[t];
    }
    {
      float qu[NU], sol[NU];
      for (int t = 0; t < NU; ++t) {
        float acc = 0.f;
        for (int u = 0; u < NQ; ++u) acc += W[u][t] * Sc[NQ + u];
        qu[t] = acc + twoR * Uo[(static_cast<long long>(k) * NU + t) * B + lane];
      }
      ldl6_solve(L, invD, qu, sol);
      for (int t = 0; t < NU; ++t) kff[t] = -sol[t];
    }
    for (int t = 0; t < NU; ++t) {
      for (int j = 0; j < NX; ++j) s.at(s.K, kK, k, t * NX + j) = K[t][j];
      s.at(s.kff, kKff, k, t) = kff[t];
    }

    // qx = A^T Sc + q; S = sym(Qxx + Qxu K); s = qx + Qxu kff.
    float qx[NX];
    At_apply(dtda, dt, Sc, qx);
    for (int i = 0; i < NX; ++i) {
      float acc = qx[i] + s.at(s.qv, kQv, k, i);
      for (int t = 0; t < NU; ++t) acc += Qxu[i][t] * kff[t];
      sv[i] = acc;
    }
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) {
        float acc = Qxx[i][j];
        for (int t = 0; t < NU; ++t) acc += Qxu[i][t] * K[t][j];
        S[i][j] = acc;
      }
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < i; ++j) {
        const float sym = 0.5f * (S[i][j] + S[j][i]);
        S[i][j] = sym;
        S[j][i] = sym;
      }
  }
}

// Stage 3: forward rollout of the delta policy from dx0 = 0.
DEV void forward_rollout(const SolveParams& p, const Scratch& s) {
  const float dt = p.dt;
  float dx[NX];
  for (int i = 0; i < NX; ++i) {
    dx[i] = 0.f;
    s.at(s.dX, kDX, 0, i) = 0.f;
  }
  for (int k = 0; k < p.N - 1; ++k) {
    float du[NU];
    for (int t = 0; t < NU; ++t) {
      float acc = 0.f;
      for (int j = 0; j < NX; ++j) acc += s.at(s.K, kK, k, t * NX + j) * dx[j];
      du[t] = acc + s.at(s.kff, kKff, k, t);
      s.at(s.dU, kDU, k, t) = du[t];
    }
    float dxn[NX];
    for (int i = 0; i < NQ; ++i) dxn[i] = dx[i] + dt * dx[NQ + i];
    for (int i = 0; i < NQ; ++i) {
      float acc = dx[NQ + i];
      for (int j = 0; j < NX; ++j) acc += s.at(s.da, kDa, k, i * NX + j) * dx[j];
      for (int j = 0; j < NU; ++j) acc += s.at(s.minv, kMinv, k, i * NU + j) * du[j];
      dxn[NQ + i] = acc;
    }
    for (int i = 0; i < NX; ++i) {
      dx[i] = dxn[i] + s.at(s.d, kD, k, i);
      s.at(s.dX, kDX, k + 1, i) = dx[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sqp_kernel(ModelConsts m, SolveParams p, const float* __restrict__ xs,
           const float* __restrict__ goals, const float* __restrict__ X,
           const float* __restrict__ U, const float* __restrict__ w,
           const float* __restrict__ rho_in, float* __restrict__ Xo,
           float* __restrict__ Uo, float* __restrict__ rho_out,
           float* __restrict__ alpha_log, float* __restrict__ step_log,
           float* __restrict__ scratch) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int B = p.B, N = p.N, Nm1 = N - 1, NA = p.num_alphas;
  if (lane >= B) return;
  const float dt = p.dt, mu = p.merit_mu;

  Scratch s;
  s.B = B;
  s.lane = lane;
  const long long nB = static_cast<long long>(B);
  s.da = scratch;
  s.minv = s.da + Nm1 * kDa * nB;
  s.d = s.minv + Nm1 * kMinv * nB;
  s.qv = s.d + Nm1 * kD * nB;
  s.sc = s.qv + N * kQv * nB;
  s.J = s.sc + N * kSc * nB;
  s.K = s.J + N * kJ * nB;
  s.kff = s.K + Nm1 * kK * nB;
  s.dX = s.kff + Nm1 * kKff * nB;
  s.dU = s.dX + N * kDX * nB;

  auto xi = [&](int k, int r) { return (static_cast<long long>(k) * NX + r) * B + lane; };
  auto ui = [&](int k, int r) { return (static_cast<long long>(k) * NU + r) * B + lane; };
  auto gi = [&](int k, int r) { return (static_cast<long long>(k) * 3 + r) * B + lane; };

  for (int k = 0; k < N; ++k)
    for (int r = 0; r < NX; ++r) Xo[xi(k, r)] = k == 0 ? xs[r * B + lane] : X[xi(k, r)];
  for (int k = 0; k < Nm1; ++k)
    for (int r = 0; r < NU; ++r) Uo[ui(k, r)] = U[ui(k, r)];
  float wl[6];
  const float* wp = nullptr;
  if (p.use_wrench) {
    for (int i = 0; i < 6; ++i) wl[i] = w[i * B + lane];
    wp = wl;
  }
  float rho = rho_in[lane];
  bool done = false;

  for (int it = 0; it < p.max_iters; ++it) {
    // ---- Stage 1: linearize + cost data; the alpha = 0 merit ----
    float base_cost = 0.f, base_cv = 0.f;
    for (int k = 0; k < Nm1; ++k) {
      float x[NX], xn[NX], u[NU], goal[3];
      for (int r = 0; r < NX; ++r) {
        x[r] = Xo[xi(k, r)];
        xn[r] = Xo[xi(k + 1, r)];
      }
      for (int r = 0; r < NU; ++r) u[r] = Uo[ui(k, r)];
      for (int r = 0; r < 3; ++r) goal[r] = goals[gi(k, r)];
      base_cost += linearize_knot(m, p, s, k, x, u, xn, wp, goal, &base_cv);
    }
    float bc_T;
    {
      float x[NX], goal[3], cb;
      for (int r = 0; r < NX; ++r) x[r] = Xo[xi(Nm1, r)];
      for (int r = 0; r < 3; ++r) goal[r] = goals[gi(Nm1, r)];
      const float err2 = cost_data(m, p, s, Nm1, x, goal, &cb);
      float v2 = 0.f;
      for (int i = 0; i < NQ; ++i) v2 += x[NQ + i] * x[NQ + i];
      bc_T = p.QN * err2 + p.dQ * v2 + p.QN * cb;
    }
    const float base_merit = (base_cost + bc_T) + mu * base_cv;

    // ---- Stages 2 and 3: Riccati sweep and rollout ----
    backward_sweep(p, s, rho, Uo, lane);
    forward_rollout(p, s);

    // ---- Stage 4: merit line search over the alphas ----
    float cost[kMaxAlphas], cv[kMaxAlphas];
    for (int c = 0; c < NA; ++c) cost[c] = cv[c] = 0.f;
    for (int k = 0; k < Nm1; ++k) {
      float x[NX], xn[NX], u[NU], dx[NX], dxn[NX], du[NU], goal[3];
      for (int r = 0; r < NX; ++r) {
        x[r] = Xo[xi(k, r)];
        xn[r] = Xo[xi(k + 1, r)];
        dx[r] = s.at(s.dX, kDX, k, r);
        dxn[r] = s.at(s.dX, kDX, k + 1, r);
      }
      for (int r = 0; r < NU; ++r) {
        u[r] = Uo[ui(k, r)];
        du[r] = s.at(s.dU, kDU, k, r);
      }
      for (int r = 0; r < 3; ++r) goal[r] = goals[gi(k, r)];
      for (int c = 0; c < NA; ++c) {
        const float alpha = ldexpf(1.f, -c);
        float xc[NX], xnc[NX], uc[NU];
        for (int r = 0; r < NX; ++r) {
          xc[r] = x[r] + alpha * dx[r];
          xnc[r] = xn[r] + alpha * dxn[r];
        }
        float u2 = 0.f;
        for (int r = 0; r < NU; ++r) {
          uc[r] = u[r] + alpha * du[r];
          u2 += uc[r] * uc[r];
        }
        cost[c] += merit_knot_cost(m, p, xc, goal, 1.f) + p.R * u2;
        float fl[3], nl[3], acc[NJ], L[6][6], invD[6];
        if (wp != nullptr) world_wrench_to_ee(m, xc, wp, fl, nl);
        forward_dynamics(m, xc, xc + NQ, uc, wp != nullptr ? fl : nullptr,
                         wp != nullptr ? nl : nullptr, acc, L, invD);
        float dq2 = 0.f, dv2 = 0.f;
        for (int i = 0; i < NQ; ++i) {
          const float eq = (xc[i] + dt * xc[NQ + i]) - xnc[i];
          const float ev = (xc[NQ + i] + dt * acc[i]) - xnc[NQ + i];
          dq2 += eq * eq;
          dv2 += ev * ev;
        }
        cv[c] += sqrtf(dq2) + sqrtf(dv2);
      }
    }
    {
      float x[NX], dx[NX], goal[3];
      for (int r = 0; r < NX; ++r) {
        x[r] = Xo[xi(Nm1, r)];
        dx[r] = s.at(s.dX, kDX, Nm1, r);
      }
      for (int r = 0; r < 3; ++r) goal[r] = goals[gi(Nm1, r)];
      for (int c = 0; c < NA; ++c) {
        const float alpha = ldexpf(1.f, -c);
        float xc[NX];
        for (int r = 0; r < NX; ++r) xc[r] = x[r] + alpha * dx[r];
        cost[c] += merit_knot_cost(m, p, xc, goal, p.QN);
      }
    }
    float alpha = 0.f;
    for (int c = NA - 1; c >= 0; --c)
      if (cost[c] + mu * cv[c] <= base_merit) alpha = ldexpf(1.f, -c);

    const bool take = !done && alpha > 0.f;
    const float scale = take ? alpha : 0.f;
    float nrm2 = 0.f;
    for (int k = 0; k < N; ++k)
      for (int r = 0; r < NX; ++r) {
        const float v = s.at(s.dX, kDX, k, r);
        nrm2 += v * v;
      }
    for (int k = 0; k < Nm1; ++k)
      for (int r = 0; r < NU; ++r) {
        const float v = s.at(s.dU, kDU, k, r);
        nrm2 += v * v;
      }
    const float step = scale * sqrtf(nrm2);
    for (int k = 0; k < N; ++k)
      for (int r = 0; r < NX; ++r) Xo[xi(k, r)] += scale * s.at(s.dX, kDX, k, r);
    for (int k = 0; k < Nm1; ++k)
      for (int r = 0; r < NU; ++r) Uo[ui(k, r)] += scale * s.at(s.dU, kDU, k, r);
    alpha_log[static_cast<long long>(it) * B + lane] = done ? 0.f : alpha;
    step_log[static_cast<long long>(it) * B + lane] = step;

    const bool rejected = !done && alpha <= 0.f;
    rho = fminf(fmaxf(rejected ? rho * p.rho_factor : rho, p.rho_min), p.rho_max);
    done = done || (take && step < p.step_tol);
  }
  rho_out[lane] = rho;
}

}  // namespace indy7

// Launches K1 on `stream`; returns cudaGetLastError() of the launch.
extern "C" int indy7_sqp_solve(indy7::ModelConsts m, indy7::SolveParams p,
                               const float* xs, const float* goals,
                               const float* X, const float* U, const float* w,
                               const float* rho_in, float* Xo, float* Uo,
                               float* rho_out, float* alpha_log,
                               float* step_log, float* scratch, void* stream) {
  const int blocks = (p.B + indy7::kThreads - 1) / indy7::kThreads;
  indy7::sqp_kernel<<<blocks, indy7::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      m, p, xs, goals, X, U, w, rho_in, Xo, Uo, rho_out, alpha_log, step_log,
      scratch);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch K1 needs for horizon N and B lanes.
extern "C" long long indy7_sqp_scratch_floats(int N, int B) {
  const long long Nm1 = N - 1;
  return (Nm1 * (indy7::kDa + indy7::kMinv + indy7::kD + indy7::kK +
                 indy7::kKff + indy7::kDU) +
          static_cast<long long>(N) *
              (indy7::kQv + indy7::kSc + indy7::kJ + indy7::kDX)) *
         B;
}
