// Team routines of the tick-epilogue kernel K2 (sm_90a): one RK4 step of
// forward dynamics spread over a team of kTeam = 8 threads of one warp.
//
// rbd.cuh's per-thread routines (K2's thread path runs them) stay as they are;
// these follow their arithmetic, item by item, with the work of a stage
// split over the team:
//   (a) joint j's rotation and torque (with the plant's friction), by
//       thread j < 6;
//   (b) the bias RNEA and the mass matrix as seven RNEA passes in lockstep:
//       the bias on thread 0, column j of M (unit acceleration, no
//       velocity, gravity or wrench) on thread 1 + j.  Measured on the
//       H100, this beat the CRBA on one thread beside the bias (the warp's
//       two roles diverge and run one after the other);
//   (c) the 6x6 LDL^T and its two triangular solves, on thread 0.
// Between phases the warp meets at __syncwarp().  Every thread of the warp
// runs every phase and reaches every __syncwarp(), whatever it owns.  The
// team's scratch (TeamScratch, and a slot of link forces per RNEA pass) and
// the model constants are in shared memory, and every thread-private array
// is indexed by compile-time constants only: nothing spills.
#pragma once

#include "rbd.cuh"

namespace indy7 {

// Shared scratch of one team.
struct TeamScratch {
  float R[NJ][3][3];   // joint rotations of the stage's q
  float v[NJ];         // the stage's joint velocities
  float tau[NJ];       // the stage's torques, friction applied
  float fl[3], nl[3];  // the RK4 step's wrench, EE-local
  float M[NJ][NJ];     // mass matrix, column j from pass 1 + j (the LDL^T
                       // reads its lower triangle)
  float bias[NJ];
  float a[NJ];         // the stage's accelerations
  float xp[NX];        // the team's predicted state
};

constexpr int kTeam = 8;          // threads per forward-dynamics chain
constexpr int kPasses = NJ + 1;   // RNEA passes a stage: the bias and M's columns
typedef float ForceSlot[NJ][6];   // one pass's link forces (lin, ang)

// One RNEA pass from the stage's rotations R: the bias (v, gravity and
// the EE-local wrench fl/nl; zero acceleration) or, for unit = j, column j
// of M (zero velocity, unit acceleration of joint j, no gravity or
// wrench).  The bias follows rnea() operation for operation.  The torques
// go to out[i * ostride] in shared memory.  The link loops are unrolled
// by two and the link forces of the forward pass wait for the backward
// pass in `f` (NJ x (lin, ang), the thread's slot of shared memory): a
// thread has 128 registers at 512 threads, and the fully unrolled pass
// spilled, with its forces in registers or not (ptxas, PERF.md).
DEV void rnea_pass(const ModelConsts& m, const float (*R)[3][3], const float* v,
                   bool bias, int unit, const float* fl, const float* nl, float (*f)[6],
                   float* out, int ostride) {
  float cl[3], ca[3];  // the force of the link the backward pass is at
  float vp_lin[3] = {0.f, 0.f, 0.f};
  float vp_ang[3] = {0.f, 0.f, 0.f};
  float ap_ang[3] = {0.f, 0.f, 0.f};
  float ap_lin[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) ap_lin[a] = bias ? -m.gravity[a] : 0.f;

#pragma unroll 2
  for (int i = 0; i < NJ; ++i) {
    const float* p = m.tree_p[i];
    const float* ax = m.axis[i];
    const float vq = bias ? v[i] : 0.f;
    const float acc = i == unit ? 1.f : 0.f;
    float wi[3], vi[3], t3[3], vJ[3];
    mtv33(R[i], vp_ang, wi);
    cross3(vp_ang, p, t3);
#pragma unroll
    for (int a = 0; a < 3; ++a) t3[a] = vp_lin[a] + t3[a];
    mtv33(R[i], t3, vi);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      vJ[a] = vq * ax[a];
      wi[a] = wi[a] + vJ[a];
    }

    float ai_ang[3], ai_lin[3], c1[3];
    mtv33(R[i], ap_ang, ai_ang);
    cross3(ap_ang, p, t3);
#pragma unroll
    for (int a = 0; a < 3; ++a) t3[a] = ap_lin[a] + t3[a];
    mtv33(R[i], t3, ai_lin);
    cross3(wi, vJ, c1);
#pragma unroll
    for (int a = 0; a < 3; ++a) ai_ang[a] = ai_ang[a] + (acc * ax[a] + c1[a]);
    cross3(vi, vJ, c1);
#pragma unroll
    for (int a = 0; a < 3; ++a) ai_lin[a] = ai_lin[a] + c1[a];

    const float mi = m.mass[i];
    const float* h = m.h[i];
    float Iv_lin[3], Iv_ang[3], Ia_lin[3], Ia_ang[3], c2[3];
    cross3(h, wi, c1);
#pragma unroll
    for (int a = 0; a < 3; ++a) Iv_lin[a] = mi * vi[a] - c1[a];
    mv33(m.I_o[i], wi, Iv_ang);
    cross3(h, vi, c1);
#pragma unroll
    for (int a = 0; a < 3; ++a) Iv_ang[a] = Iv_ang[a] + c1[a];
    cross3(h, ai_ang, c1);
#pragma unroll
    for (int a = 0; a < 3; ++a) Ia_lin[a] = mi * ai_lin[a] - c1[a];
    mv33(m.I_o[i], ai_ang, Ia_ang);
    cross3(h, ai_lin, c1);
#pragma unroll
    for (int a = 0; a < 3; ++a) Ia_ang[a] = Ia_ang[a] + c1[a];

    float f_lin[3], f_ang[3];
    cross3(wi, Iv_lin, c1);
#pragma unroll
    for (int a = 0; a < 3; ++a) f_lin[a] = Ia_lin[a] + c1[a];
    cross3(wi, Iv_ang, c1);
    cross3(vi, Iv_lin, c2);
#pragma unroll
    for (int a = 0; a < 3; ++a) f_ang[a] = Ia_ang[a] + (c1[a] + c2[a]);
    if (i == NJ - 1) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cl[a] = f_lin[a] - (bias ? fl[a] : 0.f);
        ca[a] = f_ang[a] - (bias ? nl[a] : 0.f);
      }
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        f[i][a] = f_lin[a];
        f[i][3 + a] = f_ang[a];
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      vp_lin[a] = vi[a];
      vp_ang[a] = wi[a];
      ap_lin[a] = ai_lin[a];
      ap_ang[a] = ai_ang[a];
    }
  }

#pragma unroll 2
  for (int i = NJ - 1; i >= 0; --i) {
    out[i * ostride] = dot3(ca, m.axis[i]);
    if (i > 0) {
      float fp[3], np[3], c1[3];
      mv33(R[i], cl, fp);
      mv33(R[i], ca, np);
      cross3(m.tree_p[i], fp, c1);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cl[a] = f[i - 1][a] + fp[a];
        ca[a] = f[i - 1][3 + a] + (np[a] + c1[a]);
      }
    }
  }
}

// a = M^-1 (tau - bias) by ldl6() and ldl6_solve() (one thread; M's lower
// triangle is read).
DEV void ldl_solve_unrolled(const float (*M)[NJ], const float* tau, const float* bias,
                            float* a) {
  float L[6][6], D[6], invD[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = M[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k] * D[k];
    D[j] = s;
    invD[j] = 1.f / s;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = M[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k] * D[k];
      L[i][j] = t * invD[j];
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = tau[i] - bias[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i] * invD[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * x[k];
    x[i] = s;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) a[i] = x[i];
}

// world_wrench_to_ee() from the stage's rotations: the world wrench
// w[0], w[ws], ..., w[5 ws] mapped to the last joint frame (fl, nl).
DEV void map_wrench(const ModelConsts& m, const float (*R)[3][3], const float* w, int ws,
                    float* fl, float* nl) {
  float Rw[3][3], pw[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    pw[a] = m.tree_p[0][a];
#pragma unroll
    for (int b = 0; b < 3; ++b) Rw[a][b] = R[0][a][b];
  }
#pragma unroll
  for (int i = 1; i < NJ; ++i) {
    float dp[3], Rn[3][3];
    mv33(Rw, m.tree_p[i], dp);
#pragma unroll
    for (int a = 0; a < 3; ++a) pw[a] = pw[a] + dp[a];
    mm33(Rw, R[i], Rn);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) Rw[a][b] = Rn[a][b];
  }
  const float f[3] = {w[0], w[ws], w[2 * ws]};
  float pxf[3], nn[3];
  cross3(pw, f, pxf);
#pragma unroll
  for (int a = 0; a < 3; ++a) nn[a] = w[(3 + a) * ws] - pxf[a];
  mtv33(Rw, f, fl);
  mtv33(Rw, nn, nl);
}

// fk_last()'s position with its joint loop unrolled (one thread).
DEV void ee_pos_unrolled(const ModelConsts& m, const float* q, float* pw) {
  float Rw[3][3];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    float R[3][3];
    local_rotation(m, i, q[i], R);
    if (i == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        pw[a] = m.tree_p[0][a];
#pragma unroll
        for (int b = 0; b < 3; ++b) Rw[a][b] = R[a][b];
      }
    } else {
      float dp[3], Rn[3][3];
      mv33(Rw, m.tree_p[i], dp);
#pragma unroll
      for (int a = 0; a < 3; ++a) pw[a] = pw[a] + dp[a];
      mm33(Rw, R, Rn);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) Rw[a][b] = Rn[a][b];
    }
  }
}

// Joint stops of apply_joint_limits() for joint i.
DEV void joint_limit(const ModelConsts& m, int i, bool saturate, float* q, float* v) {
  float qq = *q, vv = *v;
  if (saturate) {
    const float vl = m.velocity_limit[i];
    vv = fminf(fmaxf(vv, -vl), vl);
  }
  if (qq > m.q_upper[i]) vv = fminf(vv, 0.f);
  if (qq < m.q_lower[i]) vv = fmaxf(vv, 0.f);
  *q = fminf(fmaxf(qq, m.q_lower[i]), m.q_upper[i]);
  *v = vv;
}

// stage_accel() over the team: thread j < 6 passes joint j's q, v and u
// and gets its acceleration back.  With w non-null the RK4 step's wrench
// (w[0], w[ws], ...) is mapped first, from this stage's rotations (the
// step's start state).  `f` holds the team's kPasses force slots.
DEV float team_accel(const ModelConsts& m, TeamScratch& s, ForceSlot* f, int lt, float q,
                     float v, float u, bool friction, float kv, float kc, const float* w,
                     int ws) {
  // (a) rotations and torques
  if (lt < NJ) {
    local_rotation(m, lt, q, s.R[lt]);
    s.v[lt] = v;
    s.tau[lt] = friction ? u - kv * v - kc * tanhf(v / 0.01f) : u;
  }
  __syncwarp();
  if (w != nullptr) {
    if (lt == 0) map_wrench(m, s.R, w, ws, s.fl, s.nl);
    __syncwarp();
  }
  // (b) the bias and M's columns
  if (lt < kPasses)
    rnea_pass(m, s.R, s.v, lt == 0, lt - 1, s.fl, s.nl, f[lt],
              lt == 0 ? s.bias : &s.M[0][lt - 1], lt == 0 ? 1 : NJ);
  __syncwarp();
  // (c) the LDL^T solve
  if (lt == 0) ldl_solve_unrolled(s.M, s.tau, s.bias, s.a);
  __syncwarp();
  return s.a[lt < NJ ? lt : 0];
}

// rk4_step() over the team, thread j < 6 on joint j of x = (q, v); the
// world wrench is mapped once, at the start state.
DEV void team_rk4_step(const ModelConsts& m, TeamScratch& s, ForceSlot* f, int lt, float q,
                       float v, float u, float h, const float* w, int ws, bool friction,
                       float kv, float kc, float* oq, float* ov) {
  const float half = h / 2.f;
  const float k1v = team_accel(m, s, f, lt, q, v, u, friction, kv, kc, w, ws);
  const float k2q = v + half * k1v;
  const float k2v = team_accel(m, s, f, lt, q + half * v, k2q, u, friction, kv, kc, nullptr, 0);
  const float k3q = v + half * k2v;
  const float k3v = team_accel(m, s, f, lt, q + half * k2q, k3q, u, friction, kv, kc, nullptr, 0);
  const float k4q = v + h * k3v;
  const float k4v = team_accel(m, s, f, lt, q + h * k3q, k4q, u, friction, kv, kc, nullptr, 0);
  *oq = q + h / 6.f * (v + 2.f * k2q + 2.f * k3q + k4q);
  *ov = v + h / 6.f * (k1v + 2.f * k2v + 2.f * k3v + k4v);
}

}  // namespace indy7
