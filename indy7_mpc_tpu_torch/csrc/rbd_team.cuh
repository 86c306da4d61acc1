// Team routines of the tick-epilogue kernel K2 (sm_90a): one RK4 step of
// forward dynamics spread over a team of kTeam = 8 threads of one warp.
//
// A stage's work is split over the team, with the arithmetic of rbd.cuh's
// routines, item by item:
//   (a) joint j's rotation and torque (with the plant's friction), by
//       thread j < 6; at the step's start state, the wrench map
//       (fk_last(), wrench_to_ee()) on thread 0;
//   (b) the bias RNEA and the mass matrix as seven RNEA passes in lockstep
//       (rnea_pass, the team's own decomposition of RNEA and CRBA):
//       the bias on thread 0, column j of M (unit acceleration, no
//       velocity, gravity or wrench) on thread 1 + j.  Measured on the
//       H100, this beat the CRBA on one thread beside the bias (the warp's
//       two roles diverge and run one after the other);
//   (c) the 6x6 LDL^T and its two triangular solves (ldl6(),
//       ldl6_solve()), on thread 0.
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

// One stage's acceleration over the team, the plant's friction applied to
// the torque: thread j < 6 passes joint j's q, v and u and gets its
// acceleration back.  With w non-null the RK4 step's wrench
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
    if (lt == 0) {
      float wl[6], Rw[3][3], pw[3];
#pragma unroll
      for (int a = 0; a < 6; ++a) wl[a] = w[a * ws];
      fk_last(m, s.R, Rw, pw);
      wrench_to_ee(Rw, pw, wl, s.fl, s.nl);
    }
    __syncwarp();
  }
  // (b) the bias and M's columns
  if (lt < kPasses)
    rnea_pass(m, s.R, s.v, lt == 0, lt - 1, s.fl, s.nl, f[lt],
              lt == 0 ? s.bias : &s.M[0][lt - 1], lt == 0 ? 1 : NJ);
  __syncwarp();
  // (c) the LDL^T solve
  if (lt == 0) {
    float L[6][6], invD[6], r[6], a[6];
    ldl6(s.M, L, invD, RcpIeee());
#pragma unroll
    for (int i = 0; i < NJ; ++i) r[i] = s.tau[i] - s.bias[i];
    ldl6_solve(L, invD, r, a);
#pragma unroll
    for (int i = 0; i < NJ; ++i) s.a[i] = a[i];
  }
  __syncwarp();
  return s.a[lt < NJ ? lt : 0];
}

// One RK4 step over the team (rk4_step()'s, with the plant's friction),
// thread j < 6 on joint j of x = (q, v); the world wrench is mapped once,
// at the start state.
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
