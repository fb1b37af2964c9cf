// The pieces of a walker's lane that runs a CU trial as rounds of
// independent tasks side by side in groups of its block (K21 i_walk,
// iwalk.cuh; K23 p_walk, pwalk.cuh; K26 b_walk, bwalk.cuh): the teams of
// warps and the groups, the deal of a round's tasks over them, the task
// order (reversible in the host build) and the tasks' result slots.
//
// A task writes only its own outputs and its result slot; between
// rounds every thread derives the same scalars from the slots in the
// plain order.  The host build has one group; `task_reverse` runs its
// task loops last task first, so the CPU tests can show that no task
// reads what another task of its round writes.  Compiles as host C++ too.
#pragma once

#include "walk.cuh"

namespace gp {

using namespace hm;

constexpr int NTASK = 24;     // the most tasks of a round

#if !defined(__CUDACC__)
inline int task_reverse = 0;  // host build: task loops last task first
#endif

// the task a loop's k-th iteration runs, of n
HM_FN int task_of(int k, int n) {
#if defined(__CUDACC__)
  (void)n;
  return k;
#else
  return task_reverse ? n - 1 - k : k;
#endif
}

struct Grp {  // this thread's group: index, count, thread and size in it
  int g, ng, tid, nt;
};

// the nt threads (of a block, or of a team of it) cut into `want` groups
// (one on the host)
HM_FN Grp group_of(int tid, int nt, int want) {
  Grp G;
  G.ng = nt >= 32 * want ? want : 1;
  G.nt = nt / G.ng;
  G.g = tid / G.nt;
  G.tid = tid - G.g * G.nt;
  return G;
}

// a team of nw warps from warp w0 of a block of nt threads: the thread
// tid's place in it (the host's one thread, nt = 1, is in every team)
struct Team {
  int tid, nt;
  bool in;
};
HM_FN Team team_of(int tid, int nt, int w0, int nw) {
  Team T;
  if (nt < 32) {
    T.tid = 0;
    T.nt = 1;
    T.in = true;
  } else {
    T.tid = tid - 32 * w0;
    T.nt = 32 * nw;
    T.in = T.tid >= 0 && T.tid < T.nt;
  }
  return T;
}

HM_HD constexpr int r4(int ints) { return (ints + 3) & ~3; }
HM_HD constexpr int imax_c(int a, int b) { return a > b ? a : b; }

// a round's result slots (NTASK each; ts may be null)
struct Slots {
  float *sse, *bits;
  int *nz, *ts;
};

// a task's coding result into slot t, from the group's thread 0
HM_FN void put_res(const Slots& m, const wk::Lane& L, int t,
                   const wk::TbRes& r) {
  if (L.tid == 0) {
    m.sse[t] = r.sse;
    m.bits[t] = r.bits;
    m.nz[t] = r.nz;
    if (m.ts) m.ts[t] = r.ts;
  }
}

HM_FN wk::TbRes get_res(const Slots& m, int t) {
  wk::TbRes r;
  r.sse = m.sse[t];
  r.bits = m.bits[t];
  r.nz = m.nz[t];
  r.ts = m.ts ? m.ts[t] : 0;
  return r;
}

// positions 0 .. npos - 1 of a round of n tasks of weights w for ng
// groups (group g takes positions g, g + ng, ...; npos = n rounded up to
// ng): the tasks heaviest first (ties in index order), dealt in a snake
// (odd waves run backwards), -1 where a position has none
HM_FN void deal(const int* w, int n, int ng, int* ord) {
  int srt[NTASK];
  for (int i = 0; i < n; ++i) {
    int j = i;
    for (; j > 0 && w[srt[j - 1]] < w[i]; --j) srt[j] = srt[j - 1];
    srt[j] = i;
  }
  const int npos = (n + ng - 1) / ng * ng;
  for (int p = 0; p < npos; ++p) {
    const int wave = p / ng, lane = p - wave * ng;
    const int e = wave * ng + ((wave & 1) ? ng - 1 - lane : lane);
    ord[p] = e < n ? srt[e] : -1;
  }
}

}  // namespace gp
