// Kernel K2: the tick epilogue after the batched solve, one block (sm_90a).
//
// Replaces the Pallas TPU kernel indy7_mpc_tpu/ops/pallas/tick_kernel.py
// (_tick_kernel, launched by tick_epilogue):
//   * consensus: one RK4 prediction per wrench hypothesis from the
//     controller model (torque clamped to the effort limit, wrench mapped
//     at the start state, joint stops, no velocity saturation), scored by
//     the squared error against the observed state;
//   * argmin over (err, lane) with a first-index tie-break; a NaN error
//     wins, first NaN first, as jnp.argmin does on the readable path;
//   * the winner's first control and wrench, read straight from the
//     lane-major inputs;
//   * the ground-truth plant tick: `substeps` RK4 steps of the plant model
//     with friction inside every stage, pre-drawn actuation noise per
//     substep, the wrench re-mapped per substep, joint stops and optional
//     velocity saturation after each substep;
//   * the controller-model FK of the observed state.
//
// What bounds it on the card: latency.  The predictions are B independent
// RK4 steps (threads stride over lanes), but the plant is one state
// integrated serially (5 substeps x 4 stages of forward dynamics), done by
// one thread after a shared-memory block reduction.  A single block keeps
// the argmin inside the kernel with no second pass or atomics; the plant's
// serial chain is the floor of this kernel's time.
#include <climits>

#include <cuda_runtime.h>
#include <math.h>

#include "rbd.cuh"

namespace indy7 {

// Plant settings; mirrored by PlantParams in ops/kernels/_abi.py.
struct PlantParams {
  float dt, viscous, coulomb;
  int substeps, noise, friction, velocity_saturation, B;
};

constexpr int kTickThreads = 256;

// (a, ia) ranks before (b, ib): NaN first, then smaller, then lower index.
DEV bool ranks_before(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (!an && a != b) return a < b;
  return ia < ib;
}

__global__ void __launch_bounds__(kTickThreads)
tick_kernel(ModelConsts mc, ModelConsts mp, PlantParams pp,
            const float* __restrict__ x_last, const float* __restrict__ u_last,
            const float* __restrict__ f_batch, const float* __restrict__ U0,
            const float* __restrict__ x_cur, const float* __restrict__ f_true,
            const float* __restrict__ noise, float* __restrict__ err,
            long long* __restrict__ best, float* __restrict__ x_next,
            float* __restrict__ u_out, float* __restrict__ eep,
            float* __restrict__ f_est) {
  __shared__ float s_err[kTickThreads];
  __shared__ int s_idx[kTickThreads];
  const int tid = threadIdx.x;
  const int B = pp.B;

  // ---- consensus: one RK4 prediction per hypothesis ----
  float xl[NX], ul[NU], xo[NX];
  for (int i = 0; i < NX; ++i) {
    xl[i] = x_last[i];
    xo[i] = x_cur[i];
  }
  for (int i = 0; i < NU; ++i)
    ul[i] = fminf(fmaxf(u_last[i], -mc.effort_limit[i]), mc.effort_limit[i]);
  float my_err = INFINITY;
  int my_idx = INT_MAX;
  for (int lane = tid; lane < B; lane += blockDim.x) {
    float w[6], xp[NX];
    for (int i = 0; i < 6; ++i) w[i] = f_batch[i * B + lane];
    rk4_step(mc, xl, ul, pp.dt, w, false, 0.f, 0.f, xp);
    apply_joint_limits(mc, xp, false);
    float e = 0.f;
    for (int i = 0; i < NX; ++i) e += (xp[i] - xo[i]) * (xp[i] - xo[i]);
    err[lane] = e;
    if (ranks_before(e, lane, my_err, my_idx)) {
      my_err = e;
      my_idx = lane;
    }
  }

  // ---- block argmin over (err, lane) ----
  s_err[tid] = my_err;
  s_idx[tid] = my_idx;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (tid < stride &&
        ranks_before(s_err[tid + stride], s_idx[tid + stride], s_err[tid], s_idx[tid])) {
      s_err[tid] = s_err[tid + stride];
      s_idx[tid] = s_idx[tid + stride];
    }
    __syncthreads();
  }
  if (tid != 0) return;

  // ---- winner gather, ground-truth plant tick, trace FK ----
  const int b = s_idx[0];
  *best = b;
  float u[NU], x[NX];
  for (int i = 0; i < NU; ++i) {
    u[i] = U0[i * B + b];
    u_out[i] = u[i];
    u[i] = fminf(fmaxf(u[i], -mp.effort_limit[i]), mp.effort_limit[i]);
  }
  for (int i = 0; i < 6; ++i) f_est[i] = f_batch[i * B + b];
  float ft[6];
  for (int i = 0; i < 6; ++i) ft[i] = f_true[i];
  for (int i = 0; i < NX; ++i) x[i] = xo[i];
  const float h = pp.dt / pp.substeps;
  for (int st = 0; st < pp.substeps; ++st) {
    float us[NU], xn[NX];
    for (int i = 0; i < NU; ++i) us[i] = pp.noise ? u[i] + noise[st * NU + i] : u[i];
    rk4_step(mp, x, us, h, ft, pp.friction != 0, pp.viscous, pp.coulomb, xn);
    apply_joint_limits(mp, xn, pp.velocity_saturation != 0);
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
  for (int i = 0; i < NX; ++i) x_next[i] = x[i];
  float pe[3];
  ee_pos(mc, xo, pe);
  for (int a = 0; a < 3; ++a) eep[a] = pe[a];
}

}  // namespace indy7

// Launches K2 on `stream`; returns cudaGetLastError() of the launch.
extern "C" int indy7_tick_epilogue(indy7::ModelConsts mc, indy7::ModelConsts mp,
                                   indy7::PlantParams pp, const float* x_last,
                                   const float* u_last, const float* f_batch,
                                   const float* U0, const float* x_cur,
                                   const float* f_true, const float* noise,
                                   float* err, long long* best, float* x_next,
                                   float* u_out, float* eep, float* f_est,
                                   void* stream) {
  indy7::tick_kernel<<<1, indy7::kTickThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      mc, mp, pp, x_last, u_last, f_batch, U0, x_cur, f_true, noise, err, best,
      x_next, u_out, eep, f_est);
  return static_cast<int>(cudaGetLastError());
}
