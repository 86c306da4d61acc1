// K1's rigid-body routines (sm_90a): the per-thread routines of rbd.cuh
// that the SQP kernel's stage 1 and stage 4 items run, with every link loop
// unrolled.
//
// rbd.cuh walks the links in loops with runtime indices (R[i], f_lin[i],
// cI[i], m.tree_p[i]), so a thread keeps its per-link arrays, and a copy of
// the model constants, in local memory: in K1 a frame of 1,824 bytes a
// thread, 467 KB a block of 256 threads, which goes through L2 and slows
// every block down the more blocks run at once (PERF.md).  Here every
// per-link array is indexed by compile-time constants only, so the
// rotations, link forces, composite inertias, M and its LDL^T factor live
// in registers and the model constants are read at fixed offsets of the
// kernel's parameter bank.  The arithmetic follows rbd.cuh operation for
// operation; what differs is where values live and how often a joint
// rotation is formed:
//   * a float item forms the six rotations of its q once and shares them
//     between the forward kinematics, RNEA and CRBA, where rbd.cuh forms
//     them in each;
//   * the one-tangent Dual pass forms each rotation for the wrench map's
//     forward kinematics, again in RNEA's forward pass and again in its
//     backward pass: its 108 floats of Dual rotations kept beside the link
//     forces would not fit K1's 255 registers.
// CRBA forms link i's column force as soon as link i's composite inertia
// is whole, and keeps that (6 floats) rather than the inertia (13).
// rbd.cuh stays as it is for K2, whose thread path has 128 registers a
// thread.
#pragma once

#include "rbd.cuh"

namespace indy7 {
namespace unrolled {

// x, with the compiler told that it may have changed: what is computed
// from it again is computed, not kept in registers since the first time.
DEV float opaque(float x) {
#ifdef __CUDA_ARCH__
  asm volatile("mov.f32 %0, %0;" : "+f"(x));
#endif
  return x;
}
DEV Dual opaque(Dual x) { return Dual(opaque(x.v), opaque(x.d)); }

// The six joint rotations at q: R[i] = local_rotation(m, i, q[i]).
template <class T>
DEV void rotations(const ModelConsts& m, const T* q, T (*R)[3][3]) {
#pragma unroll
  for (int i = 0; i < NJ; ++i) local_rotation(m, i, q[i], R[i]);
}

// One link of fk_last(): the world placement (Rw, pw) of joint i from that
// of joint i - 1 and joint i's rotation R.
template <class T>
DEV void fk_link(const ModelConsts& m, int i, const T (*R)[3], T (*Rw)[3], T* pw) {
  if (i == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pw[a] = T(m.tree_p[0][a]);
#pragma unroll
      for (int b = 0; b < 3; ++b) Rw[a][b] = R[a][b];
    }
  } else {
    T dp[3];
    mv33(Rw, m.tree_p[i], dp);
#pragma unroll
    for (int a = 0; a < 3; ++a) pw[a] = pw[a] + dp[a];
    T Rn[3][3];
    mm33(Rw, R, Rn);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) Rw[a][b] = Rn[a][b];
  }
}

// fk_last() from the joint rotations R.
template <class T>
DEV void fk_last(const ModelConsts& m, const T (*R)[3][3], T (*Rw)[3], T* pw) {
#pragma unroll
  for (int i = 0; i < NJ; ++i) fk_link(m, i, R[i], Rw, pw);
}

// world_wrench_to_ee() from the last joint frame's world placement (Rw, pw).
template <class T>
DEV void wrench_to_ee(const T (*Rw)[3], const T* pw, const float* w, T* fl, T* nl) {
  const float f[3] = {w[0], w[1], w[2]};
  T pxf[3], nn[3];
  cross3(pw, f, pxf);
#pragma unroll
  for (int a = 0; a < 3; ++a) nn[a] = w[3 + a] - pxf[a];
  mtv33(Rw, f, fl);
  mtv33(Rw, nn, nl);
}

// One link of rnea()'s forward pass: link i's velocity and acceleration
// from its parent's (vp, ap; replaced by link i's), joint i's rotation R,
// velocity vq and acceleration aq; link i's force into (f_lin, f_ang).
template <class T>
DEV void rnea_forward_link(const ModelConsts& m, int i, const T (*R)[3], T vq, T aq,
                           T* vp_lin, T* vp_ang, T* ap_lin, T* ap_ang, T* f_lin,
                           T* f_ang) {
  const float* p = m.tree_p[i];
  const float* ax = m.axis[i];
  T wi[3], vi[3], t3[3], vJ[3];
  mtv33(R, vp_ang, wi);
  cross3(vp_ang, p, t3);
#pragma unroll
  for (int a = 0; a < 3; ++a) t3[a] = vp_lin[a] + t3[a];
  mtv33(R, t3, vi);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    vJ[a] = vq * ax[a];
    wi[a] = wi[a] + vJ[a];
  }

  T ai_ang[3], ai_lin[3], c1[3];
  mtv33(R, ap_ang, ai_ang);
  cross3(ap_ang, p, t3);
#pragma unroll
  for (int a = 0; a < 3; ++a) t3[a] = ap_lin[a] + t3[a];
  mtv33(R, t3, ai_lin);
  cross3(wi, vJ, c1);
#pragma unroll
  for (int a = 0; a < 3; ++a) ai_ang[a] = ai_ang[a] + (aq * ax[a] + c1[a]);
  cross3(vi, vJ, c1);
#pragma unroll
  for (int a = 0; a < 3; ++a) ai_lin[a] = ai_lin[a] + c1[a];

  const float mi = m.mass[i];
  const float* h = m.h[i];
  T Iv_lin[3], Iv_ang[3], Ia_lin[3], Ia_ang[3], c2[3];
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

  cross3(wi, Iv_lin, c1);
#pragma unroll
  for (int a = 0; a < 3; ++a) f_lin[a] = Ia_lin[a] + c1[a];
  cross3(wi, Iv_ang, c1);
  cross3(vi, Iv_lin, c2);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    f_ang[a] = Ia_ang[a] + (c1[a] + c2[a]);
    vp_lin[a] = vi[a];
    vp_ang[a] = wi[a];
    ap_lin[a] = ai_lin[a];
    ap_ang[a] = ai_ang[a];
  }
}

// One link of rnea()'s backward pass: link i's force, taken by joint i's
// rotation R into its parent's frame, added to the parent's (fp_lin, fp_ang).
template <class T>
DEV void rnea_backward_link(const ModelConsts& m, int i, const T (*R)[3], const T* f_lin,
                            const T* f_ang, T* fp_lin, T* fp_ang) {
  T fp[3], np[3], c1[3];
  mv33(R, f_lin, fp);
  mv33(R, f_ang, np);
  cross3(m.tree_p[i], fp, c1);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    fp_lin[a] = fp_lin[a] + fp[a];
    fp_ang[a] = fp_ang[a] + (np[a] + c1[a]);
  }
}

// The link forces' initial state: rest, and the base accelerating against
// gravity.
template <class T>
DEV void rnea_base(const ModelConsts& m, T* vp_lin, T* vp_ang, T* ap_lin, T* ap_ang) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    vp_lin[a] = T(0.f);
    vp_ang[a] = T(0.f);
    ap_ang[a] = T(0.f);
    ap_lin[a] = T(-m.gravity[a]);
  }
}

// rnea() from the joint rotations R; with `wrench`, (fl, nl) is the local
// spatial force on the last link.
DEV void rnea(const ModelConsts& m, const float (*R)[3][3], const float* v,
              const float* acc, bool wrench, const float* fl, const float* nl,
              float* tau) {
  float f_lin[NJ][3], f_ang[NJ][3], vp_lin[3], vp_ang[3], ap_lin[3], ap_ang[3];
  rnea_base(m, vp_lin, vp_ang, ap_lin, ap_ang);
#pragma unroll
  for (int i = 0; i < NJ; ++i)
    rnea_forward_link(m, i, R[i], v[i], acc[i], vp_lin, vp_ang, ap_lin, ap_ang, f_lin[i],
                      f_ang[i]);
  if (wrench) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      f_lin[NJ - 1][a] = f_lin[NJ - 1][a] - fl[a];
      f_ang[NJ - 1][a] = f_ang[NJ - 1][a] - nl[a];
    }
  }
#pragma unroll
  for (int i = NJ - 1; i >= 0; --i) {
    tau[i] = dot3(f_ang[i], m.axis[i]);
    if (i > 0) rnea_backward_link(m, i, R[i], f_lin[i], f_ang[i], f_lin[i - 1], f_ang[i - 1]);
  }
}

// The tangents of rnea(m, q, v, acc, f_ext(q)) on the Dual, with f_ext(q)
// the world wrench w mapped by world_wrench_to_ee() where `wrench` is set.
// Each joint rotation is formed three times, one link at a time: for the
// wrench map's forward kinematics, in RNEA's forward pass and in its
// backward pass (from opaque(q), so that the compiler forms them again
// rather than hold them).
DEV void rnea_tangent(const ModelConsts& m, const Dual* q, const Dual* v, const Dual* acc,
                      bool wrench, const float* w, float* dtau) {
  Dual fl[3], nl[3];
  if (wrench) {
    Dual Rw[3][3], pw[3];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      Dual R[3][3];
      local_rotation(m, i, q[i], R);
      fk_link(m, i, R, Rw, pw);
    }
    wrench_to_ee(Rw, pw, w, fl, nl);
  }
  Dual f_lin[NJ][3], f_ang[NJ][3], vp_lin[3], vp_ang[3], ap_lin[3], ap_ang[3];
  rnea_base(m, vp_lin, vp_ang, ap_lin, ap_ang);
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    Dual R[3][3];
    local_rotation(m, i, opaque(q[i]), R);
    rnea_forward_link(m, i, R, v[i], acc[i], vp_lin, vp_ang, ap_lin, ap_ang, f_lin[i],
                      f_ang[i]);
  }
  if (wrench) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      f_lin[NJ - 1][a] = f_lin[NJ - 1][a] - fl[a];
      f_ang[NJ - 1][a] = f_ang[NJ - 1][a] - nl[a];
    }
  }
#pragma unroll
  for (int i = NJ - 1; i >= 0; --i) {
    dtau[i] = dot3(f_ang[i], m.axis[i]).d;
    if (i > 0) {
      Dual R[3][3];
      local_rotation(m, i, opaque(q[i]), R);
      rnea_backward_link(m, i, R, f_lin[i], f_ang[i], f_lin[i - 1], f_ang[i - 1]);
    }
  }
}

// The force of unit acceleration of joint i on link i's composite body of
// first moment ch and inertia cI (crba()'s column pass starts from it).
DEV void column_force(const ModelConsts& m, int i, const float* ch, const float (*cI)[3],
                      float* F_lin, float* F_ang) {
  float t[3];
  cross3(ch, m.axis[i], t);
#pragma unroll
  for (int a = 0; a < 3; ++a) F_lin[a] = -t[a];
  mv33(cI, m.axis[i], F_ang);
}

// crba() from the joint rotations R: the lower triangle of M.
DEV void crba(const ModelConsts& m, const float (*R)[3][3], float (*M)[NJ]) {
  float cm[NJ], ch[NJ][3], cI[NJ][3][3];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    cm[i] = m.mass[i];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ch[i][a] = m.h[i][a];
#pragma unroll
      for (int b = 0; b < 3; ++b) cI[i][a][b] = m.I_o[i][a][b];
    }
  }
  // The composite pass, last link first; link i's column force
  // (F_lin, F_ang) once its composite inertia is whole.
  float F_lin[NJ][3], F_ang[NJ][3];
#pragma unroll
  for (int i = NJ - 1; i > 0; --i) {
    column_force(m, i, ch[i], cI[i], F_lin[i], F_ang[i]);
    const float mi = cm[i];
    float c[3], cn[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] = (1.f / mi) * ch[i][a];
    mv33(R[i], c, cn);
#pragma unroll
    for (int a = 0; a < 3; ++a) cn[a] = cn[a] + m.tree_p[i][a];
    // Remove the parallel-axis term, rotate, re-add about the new origin.
    float Ic[3][3], RI[3][3], In[3][3];
    const float cc = dot3(c, c), ccn = dot3(cn, cn);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        Ic[a][b] = cI[i][a][b] + (-1.f * mi) * ((a == b ? cc : 0.f) - c[a] * c[b]);
    mm33(R[i], Ic, RI);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        In[a][b] = RI[a][0] * R[i][b][0] + RI[a][1] * R[i][b][1] + RI[a][2] * R[i][b][2];
    cm[i - 1] += mi;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ch[i - 1][a] += mi * cn[a];
#pragma unroll
      for (int b = 0; b < 3; ++b)
        cI[i - 1][a][b] += In[a][b] + mi * ((a == b ? ccn : 0.f) - cn[a] * cn[b]);
    }
  }
  column_force(m, 0, ch[0], cI[0], F_lin[0], F_ang[0]);
  // The column pass: link i's column force carried to the root.
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    float Fl[3], Fa[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      Fl[a] = F_lin[i][a];
      Fa[a] = F_ang[i][a];
    }
    M[i][i] = dot3(Fa, m.axis[i]);
#pragma unroll
    for (int j = i; j > 0; --j) {
      float fl[3], fa[3], t[3];
      mv33(R[j], Fl, fl);
      mv33(R[j], Fa, fa);
      cross3(m.tree_p[j], fl, t);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        Fl[a] = fl[a];
        Fa[a] = fa[a] + t[a];
      }
      M[i][j - 1] = dot3(Fa, m.axis[j - 1]);
    }
  }
}

// ldl6(): unit-lower L and the reciprocal pivots invD of M's lower triangle.
DEV void ldl6(const float (*M)[6], float (*L)[6], float* invD) {
  float D[6];
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
}

// ldl6_solve(): x = (L D L^T)^-1 b.
DEV void ldl6_solve(const float (*L)[6], const float* invD, const float* b, float* x) {
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
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
}

// forward_dynamics() from the joint rotations R of q.
DEV void forward_dynamics(const ModelConsts& m, const float (*R)[3][3], const float* v,
                          const float* tau, bool wrench, const float* fl, const float* nl,
                          float* a, float (*L)[6], float* invD) {
  const float zero[NJ] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float bias[NJ], M[NJ][NJ], r[NJ];
  rnea(m, R, v, zero, wrench, fl, nl, bias);
  crba(m, R, M);
  ldl6(M, L, invD);
#pragma unroll
  for (int i = 0; i < NJ; ++i) r[i] = tau[i] - bias[i];
  ldl6_solve(L, invD, r, a);
}

// ee_pos_jacobian(): the EE position p and its 3 x 6 position Jacobian
// J[a][i], keeping each joint's world origin and axis rather than its
// world rotation.
DEV void ee_pos_jacobian(const ModelConsts& m, const float* q, float* p, float (*J)[NJ]) {
  float Rw[3][3], pw[3], ps[NJ][3], aw[NJ][3];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    float R[3][3];
    local_rotation(m, i, q[i], R);
    fk_link(m, i, R, Rw, pw);
#pragma unroll
    for (int a = 0; a < 3; ++a) ps[i][a] = pw[a];
    mv33(Rw, m.axis[i], aw[i]);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = ps[NJ - 1][a];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    float r[3], col[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) r[a] = p[a] - ps[i][a];
    cross3(aw[i], r, col);
#pragma unroll
    for (int a = 0; a < 3; ++a) J[a][i] = col[a];
  }
}

}  // namespace unrolled
}  // namespace indy7
