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
//     velocity saturation after each substep; skipped when substeps is 0
//     (the host tick's consensus, which reads no plant state);
//   * the controller-model FK of the observed state.
//
// What bounds it on the card: latency.  Its work is about a million
// flops at B=64 (roofline.k2_work); its floor is the chain of dependent
// forward-dynamics calls, 4 for the consensus and 4 per plant substep
// after it.  The design shortens each link of that chain:
//   * a team of 8 threads of one warp runs each forward dynamics
//     (rbd_team.cuh): a thread per joint for rotations and torques, the
//     bias and the six columns of M as seven RNEA passes in lockstep, the
//     LDL^T on one thread, with __syncwarp() between phases;
//   * both models' constants and each team's scratch (its stage's
//     rotations, torques, M, and the RNEA passes' link forces) live in
//     shared memory, and every thread-private array has compile-time
//     indices, so nothing goes to the stack;
//   * lanes stride over the teams (64 teams of 8 at 512 threads: B=64 in
//     one round); a team past the last lane runs the last lane again and
//     writes nothing, so every thread of a warp reaches every __syncwarp();
//   * after the block argmin, warp 0 alone runs the plant (each of its
//     teams runs it, team 0 writes it), the last thread the trace FK.
// Past B=256 the consensus is bound by the block's issue rate rather than
// by its chain, and a thread per lane takes it (rbd.cuh's rk4_step: a warp
// instruction serves 32 lanes where a team's serves 4), in its own
// instantiation of the kernel; the plant stays on a team.  Both paths, the
// plant and the trace FK call the same routines of rbd.cuh.
// Each lane's error comes from one team or one thread, chosen by B alone,
// and the argmin is order-free under the (err, lane) rule, so the result
// is the same bits at any block size.  Measured on the H100 (PERF.md), 512 threads beat 256, and teams
// of 8 beat teams of 16 and the CRBA in place of the six column passes.
#include <atomic>
#include <climits>

#include <cuda_runtime.h>
#include <math.h>

#include "rbd.cuh"
#include "rbd_team.cuh"

namespace indy7 {

// Plant settings; mirrored by PlantParams in ops/kernels/_abi.py.
// substeps = 0 skips the plant step (x_next is then not written).
struct PlantParams {
  float dt, viscous, coulomb;
  int substeps, noise, friction, velocity_saturation, B;
};

constexpr int kTickMaxThreads = 512;
constexpr int kTickWarp = 32;
constexpr int kMaxTeams = kTickMaxThreads / kTeam;
// The consensus runs a team per lane up to this many lanes and a thread
// per lane above, where the block is bound by its issue rate: measured on
// the H100 (PERF.md), teams were faster at B=256 and threads at 1,024 and
// 4,096.  Each way is its own instantiation of tick_kernel, so the
// per-thread path's stack and registers do not reach the team path.  The
// choice depends on B alone, so the result is the same bits at any block
// size.
constexpr int kTeamConsensusMaxB = 256;

// Dynamic shared memory, team by team: its TeamScratch, then its force
// slots (rnea_pass): 98,304 bytes for 64 teams.
extern __shared__ float tick_smem[];
constexpr int kTeamFloats =
    static_cast<int>(sizeof(TeamScratch) / sizeof(float)) + kPasses * NJ * 6;

// (a, ia) ranks before (b, ib): NaN first, then smaller, then lower index.
DEV bool ranks_before(float a, int ia, float b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an != bn) return an;
  if (!an && a != b) return a < b;
  return ia < ib;
}

template <bool kThreadPerLane>
__global__ void __launch_bounds__(kTickMaxThreads)
tick_kernel(const __grid_constant__ ModelConsts mc_in, const __grid_constant__ ModelConsts mp_in,
            const PlantParams pp,
            const float* __restrict__ x_last, const float* __restrict__ u_last,
            const float* __restrict__ f_batch, const float* __restrict__ U0,
            const float* __restrict__ x_cur, const float* __restrict__ f_true,
            const float* __restrict__ noise, float* __restrict__ err,
            long long* __restrict__ best, float* __restrict__ x_next,
            float* __restrict__ u_out, float* __restrict__ eep,
            float* __restrict__ f_est) {
  __shared__ ModelConsts s_mc, s_mp;
  __shared__ float s_err[kTickMaxThreads];
  __shared__ int s_idx[kTickMaxThreads];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  if (tid == 0) s_mc = mc_in;
  if (tid == (nthreads > kTickWarp ? kTickWarp : 0)) s_mp = mp_in;
  __syncthreads();
  const ModelConsts& mc = s_mc;
  const ModelConsts& mp = s_mp;
  const int lt = tid % kTeam;
  const int team = tid / kTeam;
  const int nteams = nthreads / kTeam;
  float* mine = tick_smem + team * kTeamFloats;
  TeamScratch& s = *reinterpret_cast<TeamScratch*>(mine);
  ForceSlot* f = reinterpret_cast<ForceSlot*>(mine + sizeof(TeamScratch) / sizeof(float));
  const int B = pp.B;

  // ---- consensus: one RK4 prediction per hypothesis ----
  // Thread j < 6 of a team owns joint j; the others carry joint 5's values.
  const int j = min(lt, NJ - 1);
  float my_err = INFINITY;
  int my_idx = INT_MAX;
  if constexpr (kThreadPerLane) {
    // A thread per lane (rbd.cuh's rk4_step): a warp instruction serves
    // 32 lanes, where a team's serves 4.
    for (int lane = tid; lane < B; lane += nthreads) {
      float x[NX], ul[NU], w[6], xp[NX];
      for (int i = 0; i < NX; ++i) x[i] = x_last[i];
      for (int i = 0; i < NU; ++i)
        ul[i] = fminf(fmaxf(u_last[i], -mc.effort_limit[i]), mc.effort_limit[i]);
      for (int i = 0; i < 6; ++i) w[i] = f_batch[i * B + lane];
      rk4_step(mc, x, ul, pp.dt, w, xp);
      apply_joint_limits(mc, xp, false);
      float e = 0.f;
      for (int i = 0; i < NX; ++i) e += (xp[i] - x_cur[i]) * (xp[i] - x_cur[i]);
      err[lane] = e;
      if (ranks_before(e, lane, my_err, my_idx)) {
        my_err = e;
        my_idx = lane;
      }
    }
  } else {
    // A team per lane.
    const float ul = fminf(fmaxf(u_last[j], -mc.effort_limit[j]), mc.effort_limit[j]);
    for (int base = 0; base < B; base += nteams) {
      const int lane = min(base + team, B - 1);
      float pq, pv;
      team_rk4_step(mc, s, f, lt, x_last[j], x_last[NQ + j], ul, pp.dt, f_batch + lane, B,
                    false, 0.f, 0.f, &pq, &pv);
      if (lt < NJ) {
        joint_limit(mc, j, false, &pq, &pv);
        s.xp[j] = pq;
        s.xp[NQ + j] = pv;
      }
      __syncwarp();
      if (lt == 0 && base + team < B) {
        float e = 0.f;
        for (int i = 0; i < NX; ++i) e += (s.xp[i] - x_cur[i]) * (s.xp[i] - x_cur[i]);
        err[lane] = e;
        if (ranks_before(e, lane, my_err, my_idx)) {
          my_err = e;
          my_idx = lane;
        }
      }
    }
  }

  // ---- block argmin over (err, lane) ----
  s_err[tid] = my_err;
  s_idx[tid] = my_idx;
  __syncthreads();
  for (int stride = nthreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride &&
        ranks_before(s_err[tid + stride], s_idx[tid + stride], s_err[tid], s_idx[tid])) {
      s_err[tid] = s_err[tid + stride];
      s_idx[tid] = s_idx[tid + stride];
    }
    __syncthreads();
  }

  // ---- winner gather, trace FK ----
  const int b = s_idx[0];
  if (tid == 0) {
    *best = b;
    for (int i = 0; i < NU; ++i) u_out[i] = U0[i * B + b];
    for (int i = 0; i < 6; ++i) f_est[i] = f_batch[i * B + b];
  }
  if (tid == nthreads - 1) {
    float R[NJ][3][3], Rw[3][3], pe[3];
    rotations(mc, x_cur, R);
    fk_last(mc, R, Rw, pe);
    for (int a = 0; a < 3; ++a) eep[a] = pe[a];
  }
  if (pp.substeps == 0 || tid >= kTickWarp) return;

  // ---- ground-truth plant tick: warp 0, written by team 0 ----
  const float u = fminf(fmaxf(U0[j * B + b], -mp.effort_limit[j]), mp.effort_limit[j]);
  float q = x_cur[j], v = x_cur[NQ + j];
  const float h = pp.dt / pp.substeps;
  for (int st = 0; st < pp.substeps; ++st) {
    const float us = pp.noise ? u + noise[st * NU + j] : u;
    team_rk4_step(mp, s, f, lt, q, v, us, h, f_true, 1, pp.friction != 0, pp.viscous,
                  pp.coulomb, &q, &v);
    joint_limit(mp, j, pp.velocity_saturation != 0, &q, &v);
  }
  if (team == 0 && lt < NJ) {
    x_next[j] = q;
    x_next[NQ + j] = v;
  }
}

// Lets both tick_kernels take their 64 teams' dynamic shared memory on
// the current device: set once per device, not on every launch.
static cudaError_t allow_team_memory() {
  static std::atomic<unsigned long long> done{0};  // one bit per device < 64
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0;
  if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
  const int bytes = kMaxTeams * kTeamFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(tick_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tick_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace indy7

// Launches K2 on `stream`: one block of `threads` threads (a power of two
// from 32 to 512) in teams of 8.  Returns a CUDA error code.
extern "C" int indy7_tick_epilogue(indy7::ModelConsts mc, indy7::ModelConsts mp,
                                   indy7::PlantParams pp, const float* x_last,
                                   const float* u_last, const float* f_batch,
                                   const float* U0, const float* x_cur,
                                   const float* f_true, const float* noise,
                                   float* err, long long* best, float* x_next,
                                   float* u_out, float* eep, float* f_est,
                                   int threads, void* stream) {
  if (threads < indy7::kTickWarp || threads > indy7::kTickMaxThreads ||
      (threads & (threads - 1)) != 0 || pp.B < 1 || pp.substeps < 0 ||
      (pp.substeps > 0 && x_next == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = indy7::allow_team_memory();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = static_cast<size_t>(threads / indy7::kTeam) * indy7::kTeamFloats * sizeof(float);
  const auto kernel = pp.B > indy7::kTeamConsensusMaxB ? indy7::tick_kernel<true>
                                                       : indy7::tick_kernel<false>;
  kernel<<<1, threads, bytes, static_cast<cudaStream_t>(stream)>>>(mc, mp, pp, x_last, u_last, f_batch, U0, x_cur, f_true, noise, err, best, x_next, u_out, eep, f_est);
  return static_cast<int>(cudaGetLastError());
}
