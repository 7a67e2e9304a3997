// The Scenario API's chunked simulation core (engine="jax" outside the
// whole-trace envelope): up to K heartbeats of a fixed fleet configuration
// with live KV (constraint (e)'s peak admission, overflow eviction, FIFO
// resume), aladdin/jsq/po2 placement and lanes the host switches on, off or
// to draining between chunks.
//
// Replaces the reference's chunk kernel, src/repro/serving/fastsim_jax.py:608
// (`_make_chunk`: a `lax.while_loop` over beats whose body admits arrivals,
// runs the placement pass and vmaps `_advance_lane_kv`, :472, across the
// lanes; `run_policy_candidate_batch` vmaps the whole chunk across policy
// candidates).
//
// What bounds it: neither bytes nor operations. A chunk reads its packed
// state once and writes it once (about 0.4 MB at 64 lanes x 64 slots: a
// tenth of a microsecond at 3.35 TB/s), and its arithmetic is a few fp64
// operations a slot a decode iteration. Beats follow each other; within a
// beat each queued request is placed after the one before it, against the
// aggregates that placement changed, and a lane's prefill, eviction and
// decode segments are a chain of dependent steps. So the kernel is bound by
// latency: beats x (sequential placements, each a warp's walk over the
// candidate lanes with an O(members^2) KV-peak test, + the longest lane's
// advance), each step a chain of dependent global and shared-memory reads,
// warp shuffles and fp64 adds.
//
// Design:
// - one CTA per candidate (the reference's vmap); the host cuts chunks at
//   every fleet change, so a chunk sees a fixed `mode` per lane (2 serving,
//   3 draining, 0 off);
// - the packed state is two flat buffers (float64 and int64) laid out as
//   `chunk_layout` in kernels/fastsim/ops.py (`Layout` below); the kernel
//   copies the input state to the output state and works there, so its
//   inputs stay as they were and the host can run a chunk again after it
//   grows the rows (slot exhaustion);
// - per-slot rows (13 arrays of W x B, 104 B a slot: 0.4 MB at 64 x 64)
//   stay in global memory, where the L2 holds them; per-lane coefficients,
//   clocks and counters and the placement pass's aggregates live in dynamic
//   shared memory (232 B a lane); a lane's weighted context is summed in
//   join order through a (W, B) scratch per candidate that the wrapper
//   allocates (`ordered_sum`, fp64.cuh);
// - thread 0 admits arrivals and keeps the backlog in rank order (EDF);
//   warps compute each serving lane's aggregates; warp 0 places the backlog
//   one request at a time (aladdin: the lazy best-fit walk by capacity norm
//   with constraint (e)'s KV peak per candidate lane; jsq/po2: the kv_now
//   admission); then every warp advances its lanes (lane w on warp w % nw),
//   reductions over a lane's slots as warp shuffles;
// - po2 draws from a counter-based generator (splitmix64 keyed on the
//   run's seed, `po2_draw` in ops.py) whose counter is part of the state, so
//   a chunk run again replays the same draws.
//
// Numerics are those of the numpy core, which is bit for bit equal to the
// reference engine: every add and multiply through __dadd_rn/__dmul_rn
// (fp64.cuh; nvcc never contracts those into a fused multiply-add),
// sequential left-associated sums of floats in the numpy core's order (the
// weighted context over the ongoing rows by join sequence, then the new
// batch by placement sequence), `k2*C + c2*b + c3` as
// ((k2*C) + (c2*b)) + c3 with c2*b computed once per segment, decode
// segments that add their iterations one after another, the budget as
// max(((a - c3) - c2*b) / k2, 0), the capacity norm through CPython's
// math.hypot algorithm (`py_hypot`), and the KV peak as h*int + j*int.
// Integer sums (batch, context, tokens) are exact in any order.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "fp64.cuh"
#include "launch.cuh"

namespace {

using namespace repro::fastsim;

constexpr int kMaxWarps = 16;
constexpr int kMaxSmem = 232448;  // what a CTA may use on Hopper
constexpr long long kBig = 1LL << 50;
constexpr long long kOvfSlots = 1, kOvfQueue = 2;

// The packed state's fields, in the order of ops.py's F_* / I_* tuples.
enum { F_T, F_THETA, NF_SCALARS };
enum { L_TW, L_K1, L_C1, L_K2, L_C2, L_C3, L_H, L_J, L_M, L_MAXBN, L_CMAXN,
       NF_LANES };
enum { R_TDS, R_TF1, R_TPE, R_TFN, R_ARR, NF_ROWS };
enum { I_K, I_IDX, I_QLEN, I_SEQC, I_SEED, I_DRAWS, I_J, I_BUSY_PK,
       I_BUSY_FIN, I_OVF, NI_SCALARS };
enum { L_JC, L_PC, L_MAXB, L_MODE, L_RANK, L_P2L, L_EMPTY, NI_LANES };
enum { R_SST, R_RID, R_LI, R_LR, R_LO, R_NSQ, R_JSQ, R_PSQ, NI_ROWS };
// the placement pass's per-lane aggregates, after the state's lane arrays
enum { A_WCTX, A_DBUD, A_DBUD_T, A_AMIN, A_TMIN, A_NORM, NF_AGG };
enum { A_CNT, A_NEWSUM, A_NEWCTX, A_CTX0, A_FLAG, NI_AGG };

struct Layout {
  size_t nf, ni, f_lane, f_row, i_lane, i_row, q;
  __host__ __device__ Layout(int W, int B, int Q) {
    const size_t wb = static_cast<size_t>(W) * B;
    f_lane = NF_SCALARS;
    f_row = f_lane + static_cast<size_t>(NF_LANES) * W;
    nf = f_row + NF_ROWS * wb;
    i_lane = NI_SCALARS;
    i_row = i_lane + static_cast<size_t>(NI_LANES) * W;
    q = i_row + NI_ROWS * wb;
    ni = q + Q;
  }
};

size_t smem_bytes(int W) {
  return 8 * static_cast<size_t>(NF_LANES + NF_AGG + NI_LANES + NI_AGG) * W;
}

struct Params {
  const double* arrival;
  const long long* l_in;
  const long long* l_real;
  const long long* rank_r;
  const double* ttft_r;
  const double* atgt_r;
  const long long* s_lo;  // (C, n) re-entrant sinks
  const double* s_f;      // (C, 3, n): t_decode_spent, first token, preempted
  const double* fin;      // (C, nf) packed state in
  const long long* iin;   // (C, ni)
  double* fout;           // (C, nf) packed state out
  long long* iout;        // (C, ni)
  double* scratch;        // (C, W, B): a lane's ordered sums
  int n, W, B, Q, C;
  double hb, gamma, ttft, atgt;
  int policy;  // 0 aladdin, 1 jsq, 2 po2
  int edf, tagged;
};

// One candidate's state as the kernel sees it: lane arrays and aggregates
// in shared memory (W entries each), rows and the queue in global memory.
struct State {
  double* lf;      // (NF_LANES + NF_AGG, W)
  long long* li;   // (NI_LANES + NI_AGG, W)
  double* rf;      // (NF_ROWS, W * B)
  long long* ri;   // (NI_ROWS, W * B)
  long long* q;
  int W;
  size_t wb;
  __device__ double& f(int k, int w) const { return lf[k * W + w]; }
  __device__ long long& i(int k, int w) const { return li[k * W + w]; }
  __device__ double& rowf(int k, size_t s) const { return rf[k * wb + s]; }
  __device__ long long& rowi(int k, size_t s) const { return ri[k * wb + s]; }
  __device__ long long& sst(size_t s) const { return rowi(R_SST, s); }
};

__device__ __forceinline__ unsigned long long mix64(unsigned long long z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}
// po2_draw in ops.py
__device__ __forceinline__ unsigned long long po2_draw(long long seed,
                                                       long long counter) {
  return mix64(mix64(static_cast<unsigned long long>(seed)) +
               static_cast<unsigned long long>(counter + 1) *
                   0x9E3779B97F4A7C15ull);
}

// (key, index) argmin across the warp; index -1 means none; ties to the
// lower index
__device__ __forceinline__ void warp_argmin(long long& key, int& idx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long k2 = __shfl_xor_sync(kFull, key, o);
    const int i2 = __shfl_xor_sync(kFull, idx, o);
    if (i2 >= 0 && (idx < 0 || k2 < key || (k2 == key && i2 < idx))) {
      key = k2;
      idx = i2;
    }
  }
}

// Lane w's aggregates for a placement pass (warp-wide; serving lanes only):
// batch (ongoing + new), new tokens and context of the new batch, context
// of the ongoing rows, weighted context (in join order),
// constraint (d)'s budgets over the ongoing rows and, for tagged traces,
// the strictest member budgets.
__device__ void lane_aggregates(const Params& p, const State& S, int w,
                                int lane, double theta, const long long* rid_,
                                bool al, bool tag_a) {
  const int B = p.B;
  const size_t o = static_cast<size_t>(w) * B;
  long long cnt = 0, newsum = 0, newctx = 0, ctx0 = 0;
  double slack = CUDART_INF, slack_t = CUDART_INF;
  double amin = CUDART_INF, tmin = CUDART_INF;
  for (int s = lane; s < B; s += 32) {
    const size_t x = o + s;
    const long long st = S.sst(x);
    if (st != 1 && st != 2) continue;
    ++cnt;
    const long long li = S.rowi(R_LI, x), lo = S.rowi(R_LO, x);
    const long long r = rid_[x];
    if (tag_a) amin = pmin(amin, p.atgt_r[r]);
    if (st == 1) {
      newsum += li;
      newctx += li + lo;
      if (tag_a) tmin = pmin(tmin, p.ttft_r[r]);
      continue;
    }
    ctx0 += li + lo;
    if (al) {
      const double m = static_cast<double>(lo > 1 ? lo - 1 : 0);
      const double tds = S.rowf(R_TDS, x);
      slack = pmin(slack, sub(mul(p.atgt, m), tds));
      if (tag_a) {
        double am = p.atgt_r[r];
        am = isinf(am) ? p.atgt : am;
        slack_t = pmin(slack_t, sub(mul(am, m), tds));
      }
    }
  }
  cnt = warp_sum(cnt);
  newsum = warp_sum(newsum);
  newctx = warp_sum(newctx);
  ctx0 = warp_sum(ctx0);
  slack = warp_min(slack);
  slack_t = warp_min(slack_t);
  amin = warp_min(amin);
  tmin = warp_min(tmin);
  // the weighted context in the numpy core's order: the ongoing rows by
  // join sequence, then the new batch by placement sequence (a float sum,
  // so the order shows in the last ulp); both sequences stay below kBig
  const double wctx = ordered_sum(
      B, lane,
      p.scratch + (static_cast<size_t>(blockIdx.x) * p.W + w) * B,
      [&](int s) -> long long {
        const long long st = S.sst(o + s);
        return st == 2   ? S.rowi(R_JSQ, o + s)
               : st == 1 ? kBig + S.rowi(R_NSQ, o + s)
                         : -1;
      },
      [&](int s) {
        return add(static_cast<double>(S.rowi(R_LI, o + s)),
                   mul(p.gamma, static_cast<double>(S.rowi(R_LR, o + s))));
      });
  if (lane == 0) {
    S.f(NF_LANES + A_WCTX, w) = wctx;
    S.i(NI_LANES + A_CNT, w) = cnt;
    S.i(NI_LANES + A_NEWSUM, w) = newsum;
    S.i(NI_LANES + A_NEWCTX, w) = newctx;
    S.i(NI_LANES + A_CTX0, w) = ctx0;
    S.f(NF_LANES + A_DBUD, w) = al ? mul(theta, max0(slack)) : 0.0;
    S.f(NF_LANES + A_DBUD_T, w) = al ? mul(theta, max0(slack_t)) : 0.0;
    S.f(NF_LANES + A_AMIN, w) = amin;
    S.f(NF_LANES + A_TMIN, w) = tmin;
  }
}

// Constraint (e) (warp-wide): the peak KV demand of lane w's members plus
// the candidate (remaining rem_c, context ctx_c), over every future step
// count at which one of them ends: max(h*sum(ctx) + j*count, max over k of
// h*(sum of ctx with rem >= k + count*k) + j*count), as kv_peak_arrays.
// Index B stands for the candidate.
__device__ double kv_peak(const Params& p, const State& S, int w, int lane,
                          long long rem_c, long long ctx_c) {
  const int B = p.B;
  const size_t o = static_cast<size_t>(w) * B;
  const double h = S.f(L_H, w), jv = S.f(L_J, w);
  auto member = [&](int s, long long& rem, long long& ctx) -> bool {
    if (s == B) {
      rem = rem_c;
      ctx = ctx_c;
      return true;
    }
    const long long st = S.sst(o + s);
    if (st != 1 && st != 2) return false;
    const long long lo = S.rowi(R_LO, o + s);
    rem = S.rowi(R_LR, o + s) - lo;
    rem = rem > 0 ? rem : 0;
    ctx = S.rowi(R_LI, o + s) + lo;
    return true;
  };
  long long sum = 0, count = 0;
  double best = -CUDART_INF;
  for (int i = lane; i <= B; i += 32) {
    long long ri, ci;
    if (!member(i, ri, ci)) continue;
    sum += ci;
    ++count;
    const long long k = ri > 1 ? ri : 1;
    long long ca = 0, sa = 0;
    for (int m = 0; m <= B; ++m) {
      long long rm, cm;
      if (member(m, rm, cm) && rm >= k) {
        ++ca;
        sa += cm;
      }
    }
    if (ca > 0) {
      const double tot = add(mul(h, static_cast<double>(sa + ca * k)),
                             mul(jv, static_cast<double>(ca)));
      best = tot > best ? tot : best;
    }
  }
  sum = warp_sum(sum);
  count = warp_sum(count);
  best = warp_max(best);
  const double peak = add(mul(h, static_cast<double>(sum)),
                          mul(jv, static_cast<double>(count)));
  return best > peak ? best : peak;
}

// The placement pass over the backlog (warp 0). Unplaced requests stay
// queued in their order at the head of the queue; the int scalars (qlen,
// seqc, draws, ovf) are updated in `sc`.
__device__ void place_pass(const Params& p, const State& S, long long* sc,
                           double theta, int nserv, int lane,
                           const long long* s_lo, const double* s_tds,
                           const double* s_tf1, const double* s_tpe) {
  const int W = p.W, B = p.B;
  const bool al = p.policy == 0, jsq = p.policy == 1;
  const bool tag_a = p.tagged && al;
  long long* q = S.q;
  const long long qlen = sc[I_QLEN];
  long long seqc = sc[I_SEQC], draws = sc[I_DRAWS], ovf = sc[I_OVF];
  long long keep = 0;
  for (long long qi = 0; qi < qlen; ++qi) {
    const long long r = q[qi];
    const long long liv = p.l_in[r], lrv = p.l_real[r], lov = s_lo[r];
    const double v = add(static_cast<double>(liv),
                         mul(p.gamma, static_cast<double>(lrv)));
    int w = -1;
    if (al) {
      const double ar = p.atgt_r[r], tr = p.ttft_r[r];
      const bool ct = tag_a && isfinite(ar);
      for (int x = lane; x < W; x += 32) {
        long long ok = 0;
        double norm = 0.0;
        if (S.i(L_MODE, x) == 2) {
          const long long cnt = S.i(NI_LANES + A_CNT, x);
          const long long bpost = cnt + 1;
          const double wctx = S.f(NF_LANES + A_WCTX, x);
          double a_eff = p.atgt, t_eff = p.ttft;
          double d_eff = S.f(NF_LANES + A_DBUD, x);
          if (ct) {  // an untagged candidate takes the scalar branch
            const double a0 = pmin(S.f(NF_LANES + A_AMIN, x), ar);
            a_eff = isinf(a0) ? p.atgt : a0;
            const double t0 = pmin(S.f(NF_LANES + A_TMIN, x), tr);
            t_eff = isinf(t0) ? p.ttft : t0;
            d_eff = S.f(NF_LANES + A_DBUD_T, x);
          }
          const double k2 = S.f(L_K2, x);
          const double budget =
              k2 > 0.0 ? max0(dvd(sub(sub(a_eff, S.f(L_C3, x)),
                                      mul(S.f(L_C2, x),
                                          static_cast<double>(bpost))),
                                  k2))
                       : CUDART_INF;
          const double pre_t = add(
              mul(S.f(L_K1, x),
                  static_cast<double>(S.i(NI_LANES + A_NEWSUM, x) + liv)),
              S.f(L_C1, x));
          if (bpost <= S.i(L_MAXB, x) && add(wctx, v) <= mul(theta, budget) &&
              pre_t <= t_eff && pre_t <= d_eff) {
            ok = 1;
            norm = py_hypot(dvd(static_cast<double>(cnt), S.f(L_MAXBN, x)),
                            dvd(wctx, S.f(L_CMAXN, x)));
          }
        }
        S.i(NI_LANES + A_FLAG, x) = ok;
        S.f(NF_LANES + A_NORM, x) = norm;
      }
      __syncwarp();
      const long long rem_c = lrv - lov > 0 ? lrv - lov : 0;
      const long long ctx_c = liv + lov;
      // lazy best fit: walk the feasible lanes by capacity norm, largest
      // first, ties in serving order, testing constraint (e) on each
      for (;;) {
        int best = -1;
        double bn = 0.0;
        long long br = 0;
        for (int x = lane; x < W; x += 32) {
          if (!S.i(NI_LANES + A_FLAG, x)) continue;
          const double nx = S.f(NF_LANES + A_NORM, x);
          const long long rx = S.i(L_RANK, x);
          if (best < 0 || nx > bn || (nx == bn && rx < br)) {
            best = x;
            bn = nx;
            br = rx;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const int b2 = __shfl_xor_sync(kFull, best, o);
          const double n2 = __shfl_xor_sync(kFull, bn, o);
          const long long r2 = __shfl_xor_sync(kFull, br, o);
          if (b2 >= 0 && (best < 0 || n2 > bn || (n2 == bn && r2 < br))) {
            best = b2;
            bn = n2;
            br = r2;
          }
        }
        if (best < 0) break;
        if (kv_peak(p, S, best, lane, rem_c, ctx_c) <=
            mul(theta, S.f(L_M, best))) {
          w = best;
          break;
        }
        __syncwarp();
        if (lane == 0) S.i(NI_LANES + A_FLAG, best) = 0;
        __syncwarp();
      }
    } else {
      // kv_now admission (_admit_naive), shared by jsq and po2
      for (int x = lane; x < W; x += 32) {
        long long ok = 0;
        if (S.i(L_MODE, x) == 2) {
          const long long cnt = S.i(NI_LANES + A_CNT, x);
          const double h = S.f(L_H, x), jv = S.f(L_J, x);
          const double kv_now = add(
              add(mul(h, static_cast<double>(S.i(NI_LANES + A_CTX0, x) +
                                             S.i(NI_LANES + A_NEWCTX, x))),
                  mul(jv, static_cast<double>(cnt))),
              add(mul(h, static_cast<double>(liv)), jv));
          ok = kv_now <= S.f(L_M, x) && cnt + 1 <= S.i(L_MAXB, x);
        }
        S.i(NI_LANES + A_FLAG, x) = ok;
      }
      __syncwarp();
      int c1 = -1, c2 = -1;
      if (!jsq) {
        if (nserv >= 2) {
          const unsigned long long u1 = po2_draw(sc[I_SEED], draws);
          const unsigned long long u2 = po2_draw(sc[I_SEED], draws + 1);
          draws += 2;
          const unsigned long long r1 = u1 % nserv, r2 = u2 % (nserv - 1);
          c1 = static_cast<int>(S.i(L_P2L, static_cast<int>(r1)));
          c2 = static_cast<int>(
              S.i(L_P2L, static_cast<int>(r2 + (r2 >= r1 ? 1 : 0))));
          if (S.f(NF_LANES + A_WCTX, c2) < S.f(NF_LANES + A_WCTX, c1)) {
            const int tmp = c1;
            c1 = c2;
            c2 = tmp;
          }
        } else if (nserv == 1) {
          c1 = static_cast<int>(S.i(L_P2L, 0));
        }
        if (c1 >= 0 && S.i(NI_LANES + A_FLAG, c1)) {
          w = c1;
        } else if (c2 >= 0 && S.i(NI_LANES + A_FLAG, c2)) {
          w = c2;
        }
      }
      if (w < 0) {
        // jsq: the smallest batch; po2's fallback: the least weighted
        // context; ties in serving order
        int best = -1;
        double bk = 0.0;
        long long br = 0;
        for (int x = lane; x < W; x += 32) {
          if (!S.i(NI_LANES + A_FLAG, x) || x == c1 || x == c2) continue;
          const double kx = jsq ? static_cast<double>(S.i(NI_LANES + A_CNT, x))
                                : S.f(NF_LANES + A_WCTX, x);
          const long long rx = S.i(L_RANK, x);
          if (best < 0 || kx < bk || (kx == bk && rx < br)) {
            best = x;
            bk = kx;
            br = rx;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const int b2 = __shfl_xor_sync(kFull, best, o);
          const double k2 = __shfl_xor_sync(kFull, bk, o);
          const long long r2 = __shfl_xor_sync(kFull, br, o);
          if (b2 >= 0 && (best < 0 || k2 < bk || (k2 == bk && r2 < br))) {
            best = b2;
            bk = k2;
            br = r2;
          }
        }
        w = best;
      }
    }
    int slot = -1;  // lane w's first free slot
    if (w >= 0) {
      const size_t o = static_cast<size_t>(w) * B;
      for (int s0 = 0; s0 < B && slot < 0; s0 += 32) {
        const unsigned free =
            __ballot_sync(kFull, s0 + lane < B && S.sst(o + s0 + lane) == 0);
        if (free) slot = s0 + __ffs(free) - 1;
      }
      if (slot < 0) ovf |= kOvfSlots;
    }
    __syncwarp();
    if (slot < 0) {  // stays queued, FIFO order kept
      if (lane == 0) q[keep] = r;
      ++keep;
      __syncwarp();
      continue;
    }
    if (lane == 0) {
      const size_t x = static_cast<size_t>(w) * B + slot;
      S.sst(x) = 1;
      S.rowi(R_RID, x) = r;
      S.rowi(R_LI, x) = liv;
      S.rowi(R_LR, x) = lrv;
      S.rowi(R_LO, x) = lov;
      S.rowf(R_TDS, x) = s_tds[r];
      S.rowf(R_TF1, x) = s_tf1[r];
      S.rowf(R_TPE, x) = s_tpe[r];
      S.rowf(R_TFN, x) = CUDART_NAN;
      S.rowf(R_ARR, x) = p.arrival[r];
      S.rowi(R_NSQ, x) = seqc;
      S.rowi(R_JSQ, x) = 0;
      S.rowi(R_PSQ, x) = 0;
      S.i(NI_LANES + A_CNT, w) += 1;
      S.i(NI_LANES + A_NEWSUM, w) += liv;
      S.i(NI_LANES + A_NEWCTX, w) += liv + lov;
      S.f(NF_LANES + A_WCTX, w) = add(S.f(NF_LANES + A_WCTX, w), v);
      if (tag_a) {
        S.f(NF_LANES + A_AMIN, w) = pmin(S.f(NF_LANES + A_AMIN, w),
                                         p.atgt_r[r]);
        S.f(NF_LANES + A_TMIN, w) = pmin(S.f(NF_LANES + A_TMIN, w),
                                         p.ttft_r[r]);
      }
    }
    ++seqc;
    __syncwarp();
  }
  if (lane == 0) {
    sc[I_QLEN] = keep;
    sc[I_SEQC] = seqc;
    sc[I_DRAWS] = draws;
    sc[I_OVF] = ovf;
  }
}

// Lane w's advance_to(t_end) with the KV semantics of the numpy core's
// _Engine._advance (warp-wide): FIFO head-blocking resume against the
// occupancy before the pops, joint prefill of the new batch and the resumed
// rows while everyone else stalls, KV-overflow eviction of the youngest
// arrival (ties to the earliest joiner), and decode segments that end at a
// finish, a KV overflow or the beat end. Finished rows park as state 5.
__device__ void advance_lane(const Params& p, const State& S, int w,
                             int lane, double t_start, double t_end) {
  const int B = p.B;
  const size_t o = static_cast<size_t>(w) * B;
  const double k1 = S.f(L_K1, w), c1 = S.f(L_C1, w), k2 = S.f(L_K2, w),
               c2 = S.f(L_C2, w), c3 = S.f(L_C3, w), h = S.f(L_H, w),
               jv = S.f(L_J, w), M = S.f(L_M, w);
  long long jc = S.i(L_JC, w), pc = S.i(L_PC, w);
  double t = S.f(L_TW, w);
  bool pend = false;
  for (int s = lane; s < B; s += 32) {
    const long long st = S.sst(o + s);
    pend = pend || st == 1 || st == 3;
  }
  // a lane that sat booting or idle starts its pending work at the beat
  // start
  if (__any_sync(kFull, pend) && t < t_start && t < t_end) t = t_start;
  const double thr = mul(0.9, M);
  while (t < t_end) {
    long long n_on = 0, C = 0;
    for (int s = lane; s < B; s += 32) {
      const size_t x = o + s;
      if (S.sst(x) == 2) {
        ++n_on;
        C += S.rowi(R_LI, x) + S.rowi(R_LO, x);
      }
    }
    n_on = warp_sum(n_on);
    C = warp_sum(C);
    const double base = add(mul(h, static_cast<double>(C)),
                            mul(jv, static_cast<double>(n_on)));
    for (;;) {  // FIFO resume: pop the head while it fits under 0.9 M
      long long key = 0;
      int head = -1;
      for (int s = lane; s < B; s += 32) {
        const size_t x = o + s;
        if (S.sst(x) == 3 && (head < 0 || S.rowi(R_PSQ, x) < key)) {
          key = S.rowi(R_PSQ, x);
          head = s;
        }
      }
      warp_argmin(key, head);
      if (head < 0) break;
      const double occ = add(
          add(base, mul(h, static_cast<double>(S.rowi(R_LI, o + head) +
                                               S.rowi(R_LO, o + head)))),
          jv);
      if (!(occ <= thr)) break;
      __syncwarp();
      if (lane == 0) S.sst(o + head) = 4;
      __syncwarp();
    }
    long long nnew = 0, nres = 0, tot = 0;
    for (int s = lane; s < B; s += 32) {
      const size_t x = o + s;
      const long long st = S.sst(x);
      if (st == 1 || st == 4) {
        (st == 1 ? nnew : nres) += 1;
        tot += S.rowi(R_LI, x) + S.rowi(R_LO, x);
      }
    }
    nnew = warp_sum(nnew);
    nres = warp_sum(nres);
    tot = warp_sum(tot);
    if (nnew + nres > 0) {
      const double dur = add(mul(k1, static_cast<double>(tot)), c1);
      const double t_pre = add(t, dur);
      // join order: new rows by placement sequence, then the resumed rows
      // by preemption sequence (a pass that reads the states only)
      for (int s = lane; s < B; s += 32) {
        const size_t x = o + s;
        const long long st = S.sst(x);
        if (st != 1 && st != 4) continue;
        const int seq = st == 1 ? R_NSQ : R_PSQ;
        const long long mine = S.rowi(seq, x);
        long long rk = 0;
        for (int m = 0; m < B; ++m)
          rk += S.sst(o + m) == st && S.rowi(seq, o + m) < mine;
        S.rowi(R_JSQ, x) = jc + (st == 1 ? 0 : nnew) + rk;
      }
      __syncwarp();
      for (int s = lane; s < B; s += 32) {
        const size_t x = o + s;
        const long long st = S.sst(x);
        if (st == 2 || st == 3 || st == 4) {
          S.rowf(R_TDS, x) = add(S.rowf(R_TDS, x), dur);
        } else if (st == 1) {
          if (isnan(S.rowf(R_TF1, x))) {
            S.rowf(R_TF1, x) = t_pre;
            S.rowi(R_LO, x) = 1;
          } else if (!isnan(S.rowf(R_TPE, x))) {
            // a KV-loss re-entrant: the stall since the reclaim
            S.rowf(R_TDS, x) = add(S.rowf(R_TDS, x),
                                   max0(sub(t_pre, S.rowf(R_TPE, x))));
          }
          S.rowf(R_TPE, x) = CUDART_NAN;
        }
        if (st == 1 || st == 4) S.sst(x) = 2;
      }
      __syncwarp();
      jc += nnew + nres;
      t = t_pre;
      continue;
    }
    if (n_on == 0) {
      t = t_end;
      break;
    }
    long long b = n_on;
    while (add(mul(h, static_cast<double>(C)),
               mul(jv, static_cast<double>(b))) > M &&
           b > 1) {
      // evict the youngest arrival, ties to the earliest joiner
      int vic = -1;
      double va = 0.0;
      long long vj = 0;
      for (int s = lane; s < B; s += 32) {
        const size_t x = o + s;
        if (S.sst(x) != 2) continue;
        const double a = S.rowf(R_ARR, x);
        const long long jq = S.rowi(R_JSQ, x);
        if (vic < 0 || a > va || (a == va && jq < vj)) {
          vic = s;
          va = a;
          vj = jq;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int v2 = __shfl_xor_sync(kFull, vic, off);
        const double a2 = __shfl_xor_sync(kFull, va, off);
        const long long j2 = __shfl_xor_sync(kFull, vj, off);
        if (v2 >= 0 && (vic < 0 || a2 > va || (a2 == va && j2 < vj))) {
          vic = v2;
          va = a2;
          vj = j2;
        }
      }
      C -= S.rowi(R_LI, o + vic) + S.rowi(R_LO, o + vic);
      --b;
      __syncwarp();
      if (lane == 0) {
        S.sst(o + vic) = 3;
        S.rowi(R_PSQ, o + vic) = pc;
      }
      ++pc;
      __syncwarp();
    }
    long long n_fin = kBig;
    for (int s = lane; s < B; s += 32) {
      const size_t x = o + s;
      if (S.sst(x) != 2) continue;
      const long long left = S.rowi(R_LR, x) - S.rowi(R_LO, x);
      const long long l1 = left > 1 ? left : 1;
      n_fin = l1 < n_fin ? l1 : n_fin;
    }
    n_fin = warp_min(n_fin);
    // a decode segment: the batch is fixed until a finish, a KV overflow
    // or the beat end
    const double cb = mul(c2, static_cast<double>(b));
    long long k = 0;
    double td = t, seg = 0.0;
    while (k < n_fin && td < t_end) {
      const long long ck = C + k * b;
      if (k > 0 &&
          add(mul(h, static_cast<double>(ck)),
              mul(jv, static_cast<double>(b))) > M &&
          b > 1)
        break;
      const double dur =
          add(add(mul(k2, static_cast<double>(ck)), cb), c3);
      ++k;
      td = add(td, dur);
      seg = add(seg, dur);
    }
    for (int s = lane; s < B; s += 32) {
      const size_t x = o + s;
      const long long st = S.sst(x);
      if (st == 2) {
        S.rowi(R_LO, x) += k;
        S.rowf(R_TDS, x) = add(S.rowf(R_TDS, x), seg);
        if (S.rowi(R_LO, x) >= S.rowi(R_LR, x)) {
          S.rowf(R_TFN, x) = td;
          S.sst(x) = 5;
        }
      } else if (st == 3) {  // preempted clocks stall too
        S.rowf(R_TDS, x) = add(S.rowf(R_TDS, x), seg);
      }
    }
    __syncwarp();
    t = td;
  }
  if (lane == 0) {
    S.f(L_TW, w) = t;
    S.i(L_JC, w) = jc;
    S.i(L_PC, w) = pc;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kMaxWarps * 32)
    chunk_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double s_t, s_theta;
  __shared__ long long sc[NI_SCALARS];
  __shared__ int s_nserv;

  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int n = p.n, W = p.W, B = p.B;
  const Layout lay(W, B, p.Q);
  const double* fin = p.fin + c * lay.nf;
  const long long* iin = p.iin + c * lay.ni;
  double* fo = p.fout + c * lay.nf;
  long long* io = p.iout + c * lay.ni;
  const long long* s_lo = p.s_lo + static_cast<size_t>(c) * n;
  const double* s_tds = p.s_f + static_cast<size_t>(c) * 3 * n;
  const double* s_tf1 = s_tds + n;
  const double* s_tpe = s_tds + 2 * n;
  const bool al = p.policy == 0, tag_a = p.tagged && al;

  State S;
  S.lf = reinterpret_cast<double*>(smem);
  S.li = reinterpret_cast<long long*>(S.lf + (NF_LANES + NF_AGG) * W);
  S.rf = fo + lay.f_row;
  S.ri = io + lay.i_row;
  S.q = io + lay.q;
  S.W = W;
  S.wb = static_cast<size_t>(W) * B;

  // the state in -> out (the kernel works on the output); lanes to shared
  for (size_t k = tid; k < lay.nf; k += blockDim.x) fo[k] = fin[k];
  for (size_t k = tid; k < lay.ni; k += blockDim.x) io[k] = iin[k];
  for (int k = tid; k < NF_LANES * W; k += blockDim.x)
    S.lf[k] = fin[lay.f_lane + k];
  for (int k = tid; k < NI_LANES * W; k += blockDim.x)
    S.li[k] = iin[lay.i_lane + k];
  if (tid == 0) {
    s_t = fin[F_T];
    s_theta = fin[F_THETA];
    for (int k = 0; k < NI_SCALARS; ++k) sc[k] = iin[k];
    int ns = 0;
    for (int w = 0; w < W; ++w) ns += iin[lay.i_lane + L_MODE * W + w] == 2;
    s_nserv = ns;
  }
  __syncthreads();
  const double theta = s_theta;
  const long long* rid = S.ri + R_RID * S.wb;

  for (;;) {
    bool mine = false;
    for (size_t x = tid; x < S.wb; x += blockDim.x) {
      const long long st = S.sst(x);
      mine = mine || (st > 0 && st < 5);
    }
    const bool occupied = __syncthreads_or(mine);
    if (!(sc[I_J] < sc[I_K]) ||
        (sc[I_IDX] >= n && sc[I_QLEN] == 0 && !occupied))
      break;
    const double t = s_t;
    __syncthreads();
    if (tid == 0) {  // admit arrivals <= t (the trace is sorted)
      long long idx = sc[I_IDX], qlen = sc[I_QLEN];
      while (idx < n && p.arrival[idx] <= t) {
        if (qlen >= p.Q) {
          sc[I_OVF] |= kOvfQueue;
          break;
        }
        S.q[qlen++] = idx++;
      }
      if (p.edf) {
        // priority, then deadline: insertion sort by the host's total
        // rank (unique, so any sort gives this order)
        for (long long i = 1; i < qlen; ++i) {
          const long long r = S.q[i];
          const long long key = p.rank_r[r];
          long long j = i;
          for (; j > 0 && p.rank_r[S.q[j - 1]] > key; --j) S.q[j] = S.q[j - 1];
          S.q[j] = r;
        }
      }
      sc[I_IDX] = idx;
      sc[I_QLEN] = qlen;
    }
    __syncthreads();
    if (sc[I_QLEN] > 0) {
      for (int w = warp; w < W; w += nw)
        if (S.i(L_MODE, w) == 2)
          lane_aggregates(p, S, w, lane, theta, rid, al, tag_a);
      __syncthreads();
      if (warp == 0)
        place_pass(p, S, sc, theta, s_nserv, lane, s_lo, s_tds, s_tf1,
                   s_tpe);
      __syncthreads();
    }
    const double t_next = add(t, p.hb);
    for (int w = warp; w < W; w += nw) {
      const long long md = S.i(L_MODE, w);
      if (md == 2 || md == 3) advance_lane(p, S, w, lane, t, t_next);
    }
    __syncthreads();
    // the host's billing replay: online lanes busy with ongoing or new
    // rows, and the first beat at which a draining lane held nothing
    for (int w = warp; w < W; w += nw) {
      bool loaded = false, occ = false;
      for (int s = lane; s < B; s += 32) {
        const long long st = S.sst(static_cast<size_t>(w) * B + s);
        loaded = loaded || st == 1 || st == 2;
        occ = occ || (st > 0 && st < 5);
      }
      loaded = __any_sync(kFull, loaded);
      occ = __any_sync(kFull, occ);
      if (lane == 0) S.i(NI_LANES + A_FLAG, w) = loaded | (occ << 1);
    }
    __syncthreads();
    if (tid == 0) {
      long long busy = 0;
      for (int w = 0; w < W; ++w) {
        const long long md = S.i(L_MODE, w), fl = S.i(NI_LANES + A_FLAG, w);
        busy += md == 2 && (fl & 1);
        if (md == 3 && !(fl & 2) && S.i(L_EMPTY, w) == kBig)
          S.i(L_EMPTY, w) = sc[I_J];
      }
      sc[I_BUSY_PK] = busy > sc[I_BUSY_PK] ? busy : sc[I_BUSY_PK];
      sc[I_BUSY_FIN] = busy;
      sc[I_J] += 1;
      s_t = t_next;
    }
    __syncthreads();
  }
  // lanes and scalars back to the output state
  for (int k = tid; k < NF_LANES * W; k += blockDim.x)
    fo[lay.f_lane + k] = S.lf[k];
  for (int k = tid; k < NI_LANES * W; k += blockDim.x)
    io[lay.i_lane + k] = S.li[k];
  if (tid == 0) {
    fo[F_T] = s_t;
    fo[F_THETA] = s_theta;
    for (int k = 0; k < NI_SCALARS; ++k) io[k] = sc[k];
  }
}

}  // namespace

extern "C" int fastsim_chunk_launch(
    const void* arrival, const void* l_in, const void* l_real,
    const void* rank_r, const void* ttft_r, const void* atgt_r,
    const void* s_lo, const void* s_f, const void* fin, const void* iin,
    void* fout, void* iout, void* scratch, int n, int W, int B, int Q, int C,
    double hb,
    double gamma, double ttft, double atgt, int policy, int edf, int tagged,
    void* stream) {
  const int nw = W < kMaxWarps ? W : kMaxWarps;
  const size_t bytes = smem_bytes(W);
  if (n < 1 || W < 1 || B < 1 || Q < 1 || C < 1 || policy < 0 ||
      policy > 2 || bytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Params p;
  p.arrival = static_cast<const double*>(arrival);
  p.l_in = static_cast<const long long*>(l_in);
  p.l_real = static_cast<const long long*>(l_real);
  p.rank_r = static_cast<const long long*>(rank_r);
  p.ttft_r = static_cast<const double*>(ttft_r);
  p.atgt_r = static_cast<const double*>(atgt_r);
  p.s_lo = static_cast<const long long*>(s_lo);
  p.s_f = static_cast<const double*>(s_f);
  p.fin = static_cast<const double*>(fin);
  p.iin = static_cast<const long long*>(iin);
  p.fout = static_cast<double*>(fout);
  p.iout = static_cast<long long*>(iout);
  p.scratch = static_cast<double*>(scratch);
  p.n = n;
  p.W = W;
  p.B = B;
  p.Q = Q;
  p.C = C;
  p.hb = hb;
  p.gamma = gamma;
  p.ttft = ttft;
  p.atgt = atgt;
  p.policy = policy;
  p.edf = edf;
  p.tagged = tagged;
  chunk_kernel<<<C, nw * 32, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
