// Native graph Smith-Waterman engine: exact fill + traceback.
//
// Host-side runtime companion to the batched device scorer: the device ranks
// orientations and computes scores/uniqueness for thousands of reads at
// once (paragraph_tpu/ops/multi_sw.py); this library produces the node-CIGARs
// for kept reads at C speed. It implements the same recurrences and
// traceback preference rules as paragraph_tpu/align/gssw.py (which is
// differentially validated cell-exactly against the reference gssw C
// library at /root/reference/external/gssw/gssw.c) — written from the
// derived algorithm, not copied.
//
// Build: make -C native   (produces libparagraph_sw.so)

#if defined(__AVX2__)
#include <immintrin.h>
#endif
#include <algorithm>
#include <atomic>
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kGapOpen = 6;
constexpr int kGapExtend = 1;
constexpr int kMatch = 1;
constexpr int kMismatch = 4;

inline int nt_class(char c) {
  switch (c) {
    case 'A': return 0;
    case 'C': return 1;
    case 'G': return 2;
    case 'T': return 3;
    default: return 4;
  }
}

inline int score_of(int ref_c, int read_c) {
  if (ref_c == 4 || read_c == 4) return 0;
  return ref_c == read_c ? kMatch : -kMismatch;
}

struct Node {
  std::string seq;          // uppercased
  std::vector<int> preds;   // sorted ids
};

struct GraphCtx {
  std::vector<Node> nodes;
  // per-context fill scratch, reused across calls (a context is owned by
  // one thread — the Python side creates one engine per worker)
  void* scratch = nullptr;
};

struct NodeFill {
  // Only H is materialised ([rows][m_pad]); E and F are recomputed on
  // demand during traceback from H + the node's seed column (they are
  // pure functions of those), which cuts fill memory traffic 3x and
  // lets the row loops auto-vectorize.
  //
  // Banded fills (gsw_align_at) fill only the row suffix [row0, len):
  // H holds (len - row0) rows and seed_E is E entering row `row0`.
  // row0 == -1 marks a node outside the band (no fill at all).
  std::vector<int32_t> H;         // (len - row0) * m_pad
  std::vector<int32_t> seed_E;    // m_pad: E entering row `row0`
  std::vector<int32_t> last_H;    // m_pad
  std::vector<int32_t> next_E;    // m_pad
  int row0 = 0;
  int score1 = 0;
  int ref_end1 = -1;
  int read_end1 = -1;
};

struct FillResult {
  std::vector<NodeFill> fills;
  int max_node = 0;
  int max_score = 0;
  int m_real = 0;
  int m_pad = 0;
};

// Fill nodes in topological order with cross-node seeding (elementwise
// max over predecessors' boundary states), including the striped
// padding-lane semantics (read padded to 16-lane stripes with score-0
// positions).
//
// `window` (nullable) is a per-node first-fill-row array for banded
// fills: row0[nid] == -1 skips the node entirely, row0[nid] > 0 fills
// only the row suffix with zero seeds (a fresh local-alignment start —
// exact whenever the true alignment path lies inside the band, which the
// caller verifies against the device-reported score). `stop_node` stops
// the sweep after that node (banded fills never need later nodes), and
// `stop_row` caps the final node's filled rows.
void fill_graph(const GraphCtx& g, const char* read, int m_real,
                FillResult* out, const int* window = nullptr,
                int stop_node = -1, int stop_row = -1) {
  const int m_pad = ((m_real + 15) / 16) * 16;
  out->m_real = m_real;
  out->m_pad = m_pad;

  // per-read substitution profile [5][m_pad]: prof[rc][j] = score of
  // node base class rc against read position j (0 on pad lanes / N)
  std::vector<int32_t> prof((size_t)5 * m_pad, 0);
  for (int rc = 0; rc < 4; ++rc) {
    int32_t* p = &prof[(size_t)rc * m_pad];
    for (int j = 0; j < m_real; ++j) {
      const int c = nt_class(read[j]);
      p[j] = (c == 4) ? 0 : (c == rc ? kMatch : -kMismatch);
    }
    for (int j = m_real; j < m_pad; ++j) p[j] = 0;
  }

  const size_t n = g.nodes.size();
  if (out->fills.size() != n) {
    out->fills.clear();
    out->fills.resize(n);
  }
  out->max_node = 0;
  out->max_score = 0;
  bool have_max = false;

  std::vector<int32_t> seed_H(m_pad), seed_E(m_pad);
  std::vector<int32_t> ecol(m_pad), hp(m_pad), gscan(m_pad);

  const size_t n_sweep =
      stop_node >= 0 ? std::min(n, (size_t)stop_node + 1) : n;
  for (size_t nid = 0; nid < n_sweep; ++nid) {
    const Node& node = g.nodes[nid];
    NodeFill& f = out->fills[nid];
    const int row0 = window ? window[nid] : 0;
    f.row0 = row0;
    if (row0 < 0) continue;  // outside the band
    const int node_len = (int)node.seq.size();
    const int len = (stop_row >= 0 && (int)nid == stop_node)
                        ? std::min(node_len, stop_row + 1)
                        : node_len;
    f.H.resize((size_t)(len - row0) * m_pad);  // fully overwritten below

    bool any_pred = false;
    if (row0 == 0) {
      for (int p : node.preds) {
        const NodeFill& pk = out->fills[p];
        if (window && pk.row0 < 0) continue;  // unbanded pred: zero seed
        if (!any_pred) {
          seed_H = pk.last_H;
          seed_E = pk.next_E;
          any_pred = true;
        } else {
          for (int j = 0; j < m_pad; ++j) {
            seed_H[j] = std::max(seed_H[j], pk.last_H[j]);
            seed_E[j] = std::max(seed_E[j], pk.next_E[j]);
          }
        }
      }
    }
    if (!any_pred) {
      std::fill(seed_H.begin(), seed_H.end(), 0);
      std::fill(seed_E.begin(), seed_E.end(), 0);
    }
    f.seed_E = seed_E;
    ecol = seed_E;
    int score1 = 0, ref_end1 = -1, read_end1 = m_real - 1;

    const int32_t* h_prev = seed_H.data();
    for (int i = row0; i < len; ++i) {
      const int32_t* prow =
          &prof[(size_t)nt_class(node.seq[(size_t)i]) * m_pad];
      int32_t* Hrow = &f.H[(size_t)(i - row0) * m_pad];
      int32_t* hpv = hp.data();
      const int32_t* ec = ecol.data();
      // 1) H' = max(0, diag + s, E)  — vectorizable shift/max
      {
        int32_t v = prow[0] > 0 ? prow[0] : 0;  // diag(0) = 0
        hpv[0] = v > ec[0] ? v : ec[0];
      }
      for (int j = 1; j < m_pad; ++j) {
        int32_t v = h_prev[j - 1] + prow[j];
        if (v < 0) v = 0;
        hpv[j] = v > ec[j] ? v : ec[j];
      }
      // 2) F prefix scan in closed form over H' (valid for gapO >= gapE:
      //    F never improves by chaining through an F-derived H), then
      //    H = max(H', F). This is the one serial loop of the fill, so
      //    it gets a SIMD blocked prefix-max: g[j] = max_{k<=j}
      //    (H'[k] + k*gapE) via 3 in-register log steps per 8-lane
      //    block plus a running carry, then
      //    H[j] = max(H'[j], max(0, g[j-1] - gapOpen - (j-1)*gapExtend)).
#if defined(__AVX2__)
      {
        int32_t* gbuf = gscan.data();
        __m256i carry = _mm256_setzero_si256();  // H' >= 0, so 0 is -inf
        const __m256i vge8 = _mm256_set1_epi32(8 * kGapExtend);
        const __m256i bcast7 = _mm256_set1_epi32(7);
        __m256i jterm = _mm256_setr_epi32(
            0, kGapExtend, 2 * kGapExtend, 3 * kGapExtend,
            4 * kGapExtend, 5 * kGapExtend, 6 * kGapExtend,
            7 * kGapExtend);
        for (int j = 0; j < m_pad; j += 8) {
          __m256i x = _mm256_loadu_si256((const __m256i*)(hpv + j));
          x = _mm256_add_epi32(x, jterm);
          jterm = _mm256_add_epi32(jterm, vge8);
          __m256i lo = _mm256_permute2x128_si256(x, x, 0x08);
          x = _mm256_max_epi32(x, _mm256_alignr_epi8(x, lo, 12));
          lo = _mm256_permute2x128_si256(x, x, 0x08);
          x = _mm256_max_epi32(x, _mm256_alignr_epi8(x, lo, 8));
          x = _mm256_max_epi32(x, _mm256_permute2x128_si256(x, x, 0x08));
          x = _mm256_max_epi32(x, carry);
          _mm256_storeu_si256((__m256i*)(gbuf + j), x);
          carry = _mm256_permutevar8x32_epi32(x, bcast7);
        }
        Hrow[0] = hpv[0];
        for (int j = 1; j < m_pad; ++j) {  // auto-vectorizes
          const int32_t fv0 =
              gbuf[j - 1] - kGapOpen - (j - 1) * kGapExtend;
          const int32_t fv = fv0 > 0 ? fv0 : 0;
          Hrow[j] = hpv[j] > fv ? hpv[j] : fv;
        }
      }
#else
      {
        int32_t gmax = INT32_MIN / 2;
        Hrow[0] = hpv[0];
        for (int j = 1; j < m_pad; ++j) {
          const int32_t cand = hpv[j - 1] - kGapOpen;
          gmax -= kGapExtend;
          if (cand > gmax) gmax = cand;
          const int32_t fv = gmax > 0 ? gmax : 0;
          Hrow[j] = hpv[j] > fv ? hpv[j] : fv;
        }
      }
#endif
      // 3) E for the next row — vectorizable
      int32_t* ecw = ecol.data();
      for (int j = 0; j < m_pad; ++j) {
        int32_t ev = ecw[j] - kGapExtend;
        const int32_t hv = Hrow[j] - kGapOpen;
        if (hv > ev) ev = hv;
        ecw[j] = ev > 0 ? ev : 0;
      }
      // 4) row max — vectorizable reduction
      int32_t col_max = 0;
      for (int j = 0; j < m_pad; ++j)
        if (Hrow[j] > col_max) col_max = Hrow[j];
      h_prev = Hrow;
      if (col_max > score1) {
        score1 = col_max;
        ref_end1 = i;
      }
    }
    if (ref_end1 >= 0) {
      const int32_t* best_row = &f.H[(size_t)(ref_end1 - row0) * m_pad];
      for (int j = 0; j < m_pad; ++j) {
        if (best_row[j] == score1 && j < read_end1) {
          read_end1 = j;
          break;
        }
      }
    } else if (m_real > 1) {
      read_end1 = 0;  // all-zero fill: gssw scans its zeroed pvHmax
    }
    if (len > 0) {
      f.last_H.assign(h_prev, h_prev + m_pad);
    } else {
      f.last_H = seed_H;
    }
    f.next_E = ecol;
    f.score1 = score1;
    f.ref_end1 = ref_end1;
    f.read_end1 = read_end1;
    if (!have_max || score1 > out->max_score) {
      out->max_node = (int)nid;
      out->max_score = score1;
      have_max = true;
    }
  }
}

bool ends_at_multiple_nodes(const FillResult& r) {
  int seen = 0;
  for (const NodeFill& f : r.fills) {
    bool any = false;
    const int rows = (int)(f.H.size() / r.m_pad);
    for (int i = 0; i < rows && !any; ++i) {
      const int32_t* row = &f.H[(size_t)i * r.m_pad];
      for (int j = 0; j < r.m_real; ++j) {
        if (row[j] == r.max_score) { any = true; break; }
      }
    }
    if (any && ++seen > 1) return true;
  }
  return false;
}

struct CigOp {
  int len;
  char op;
};

void push_back_op(std::vector<CigOp>* c, char op, int len) {
  if (!c->empty() && c->back().op == op) c->back().len += len;
  else c->push_back({len, op});
}

void push_front_op(std::vector<CigOp>* c, char op, int len) {
  if (!c->empty() && c->front().op == op) c->front().len += len;
  else c->insert(c->begin(), {len, op});
}

struct Mapping {
  int score = 0;
  int position = 0;
  std::vector<int> node_ids;
  std::vector<std::vector<CigOp>> cigars;
};

// Traceback with gssw preference rules: in H diag > F-close > E-close;
// in gaps open > extend; node boundaries crossed via sorted predecessors.
//
// start_node >= 0 traces from the given end cell (banded fills, where the
// device supplies the tie-broken global max) instead of the fill's max.
// Returns false when the walk gets stuck — impossible on a full fill, and
// on a banded fill the signal that the band was too narrow (the caller
// falls back to a full-width alignment).
bool trace_back(const GraphCtx& g, const FillResult& r, const char* read,
                Mapping* gm, int start_node = -1, int start_ref = -1,
                int start_read = -1) {
  const int m_pad = r.m_pad;
  int n_id = start_node >= 0 ? start_node : r.max_node;
  const NodeFill* f = &r.fills[n_id];
  int ref_end = start_node >= 0 ? start_ref : f->ref_end1;
  int read_end = start_node >= 0 ? start_read : f->read_end1;
  int score = 0;
  if (ref_end >= f->row0 && read_end >= 0)
    score = f->H[(size_t)(ref_end - f->row0) * m_pad + read_end];
  gm->score = score;

  std::vector<int> node_ids_rev;
  std::vector<std::vector<CigOp>> cigars_rev;
  bool gap_in_read = false;
  int end_soft_clip = r.m_real - read_end - 1;

  // All accessors are row0-aware: a banded fill stores only the row
  // suffix [row0, len). Reads below row0 mean the band was too narrow —
  // flagged and surfaced as a failed traceback.
  bool oob = false;
  auto H = [&](const NodeFill* nf, int i, int j) -> int32_t {
    if (i < nf->row0) { oob = true; return INT32_MIN / 2; }
    return nf->H[(size_t)(i - nf->row0) * m_pad + j];
  };
  // E/F are recomputed from H + the node's seed column (exact same
  // recurrences the fill evaluates); traceback touches O(path) cells so
  // the O(i)/O(j) walks are negligible.
  auto E = [&](const NodeFill* nf, int i, int j) -> int32_t {
    if (i < nf->row0) { oob = true; return INT32_MIN / 2; }
    int32_t e = nf->seed_E[j];
    for (int k = nf->row0 + 1; k <= i; ++k) {
      int32_t ev = e - kGapExtend;
      const int32_t hv =
          nf->H[(size_t)(k - 1 - nf->row0) * m_pad + j] - kGapOpen;
      if (hv > ev) ev = hv;
      e = ev > 0 ? ev : 0;
    }
    return e;
  };
  auto F = [&](const NodeFill* nf, int i, int j) -> int32_t {
    if (i < nf->row0) { oob = true; return INT32_MIN / 2; }
    int32_t fv = 0;
    const int32_t* Hrow = &nf->H[(size_t)(i - nf->row0) * m_pad];
    for (int k = 1; k <= j; ++k) {
      int32_t v = fv - kGapExtend;
      const int32_t hv = Hrow[k - 1] - kGapOpen;
      if (hv > v) v = hv;
      fv = v > 0 ? v : 0;
    }
    return fv;
  };

  while (score > 0) {
    f = &r.fills[n_id];
    const std::string& nseq = g.nodes[n_id].seq;
    std::vector<CigOp> cig;
    int i = ref_end, j = read_end;
    bool g_read = gap_in_read, g_ref = false;
    int score_here = g_read ? E(f, i, j) : H(f, i, j);

    while (score_here > 0 && i >= 0 && j >= 0) {
      if (g_read) {
        if (i > 0) {
          if (score_here == H(f, i - 1, j) - kGapOpen) {
            push_back_op(&cig, 'D', 1);
            score_here += kGapOpen;
            --i;
            g_read = false;
            continue;
          }
          if (score_here == E(f, i - 1, j) - kGapExtend) {
            push_back_op(&cig, 'D', 1);
            score_here += kGapExtend;
            --i;
            continue;
          }
          return false;  // stuck in read gap
        }
        break;  // cross node boundary in gap
      }
      if (g_ref) {
        if (j > 0) {
          if (score_here == H(f, i, j - 1) - kGapOpen) {
            push_back_op(&cig, 'I', 1);
            score_here += kGapOpen;
            --j;
            g_ref = false;
            continue;
          }
          if (score_here == F(f, i, j - 1) - kGapExtend) {
            push_back_op(&cig, 'I', 1);
            score_here += kGapExtend;
            --j;
            continue;
          }
        }
        return false;  // stuck in ref gap
      }
      const char rc = nseq[(size_t)i];
      const char qc = read[j];
      const int a = score_of(nt_class(rc), nt_class(qc));
      bool found = false;
      if (i > 0 && j > 0) {
        if (score_here == H(f, i - 1, j - 1) + a) {
          push_back_op(&cig, (rc == 'N' || qc == 'N') ? 'N'
                              : (rc == qc ? 'M' : 'X'), 1);
          score_here -= a;
          --i;
          --j;
          found = true;
        }
      } else {
        if (score_here == a) {
          if (rc == 'N' || qc == 'N') push_back_op(&cig, 'N', 1);
          else if (rc == qc) push_back_op(&cig, 'M', 1);
          score_here -= a;
          --i;
          --j;
          found = true;
        }
      }
      if (found) continue;
      if (j > 0 && score_here == F(f, i, j)) { g_ref = true; continue; }
      if (score_here == E(f, i, j)) { g_read = true; continue; }
      if (i == 0) break;  // cross node boundary diagonally
      return false;  // stuck in main matrix (banded: band too narrow)
    }

    std::reverse(cig.begin(), cig.end());
    // merge equal neighbours after reversal
    std::vector<CigOp> merged;
    for (const CigOp& op : cig) push_back_op(&merged, op.op, op.len);
    cig.swap(merged);

    if (end_soft_clip) {
      push_back_op(&cig, 'S', end_soft_clip);
      end_soft_clip = 0;
    }
    node_ids_rev.push_back(n_id);
    cigars_rev.push_back(cig);

    ref_end = i;
    read_end = j;
    gap_in_read = g_read;
    score = score_here;
    if (score != 0 && ref_end > 0) return false;  // stopped mid-matrix
    if (score == 0) {
      if (read_end > -1) push_front_op(&cigars_rev.back(), 'S', read_end + 1);
      break;
    }

    int best_prev = -1;
    for (int cn : g.nodes[n_id].preds) {
      const NodeFill* cf = &r.fills[cn];
      if (cf->row0 < 0) continue;  // pred outside the band
      const int last = (int)g.nodes[cn].seq.size() - 1;
      if (!gap_in_read) {
        if (read_end > 0) {
          const char rc = nseq[(size_t)ref_end];
          const char qc = read[read_end];
          const int a = score_of(nt_class(rc), nt_class(qc));
          if (score == H(cf, last, read_end - 1) + a) {
            best_prev = cn;
            push_front_op(&cigars_rev.back(),
                          (rc == 'N' || qc == 'N') ? 'N'
                           : (rc == qc ? 'M' : 'X'), 1);
            score -= a;
            --read_end;
            break;
          }
        }
      } else {
        if (score == H(cf, last, read_end) - kGapOpen) {
          best_prev = cn;
          push_front_op(&cigars_rev.back(), 'D', 1);
          score += kGapOpen;
          gap_in_read = false;
          break;
        }
        if (score == E(cf, last, read_end) - kGapExtend) {
          best_prev = cn;
          push_front_op(&cigars_rev.back(), 'D', 1);
          score += kGapExtend;
          break;
        }
      }
    }
    if (best_prev < 0) {
      if (score != 0) return false;  // no valid previous node
      if (read_end > -1) push_front_op(&cigars_rev.back(), 'S', read_end + 1);
      break;
    }
    n_id = best_prev;
    ref_end = (int)g.nodes[n_id].seq.size() - 1;
  }

  gm->position = ref_end + 1 >= 0 ? ref_end + 1 : 0;
  gm->node_ids.assign(node_ids_rev.rbegin(), node_ids_rev.rend());
  gm->cigars.assign(cigars_rev.rbegin(), cigars_rev.rend());
  return true;
}

// Per-node first-fill rows for a banded fill ending at (end_node,
// end_ref): walk the band budget backwards through predecessors; a node
// keeps the smallest row0 (largest suffix) any successor demands.
// Returns the rows to fill in `row0` (-1 = skip).
void compute_window(const GraphCtx& g, int end_node, int end_ref,
                    int budget, std::vector<int>* row0) {
  const size_t n = g.nodes.size();
  row0->assign(n, -1);
  std::vector<int> leftover(n, -1);  // budget left before the filled rows
  (*row0)[end_node] = std::max(0, end_ref + 1 - budget);
  leftover[end_node] = budget - (end_ref + 1 - (*row0)[end_node]);
  for (int nid = end_node; nid >= 0; --nid) {
    if ((*row0)[nid] != 0 || leftover[nid] <= 0) continue;
    const int a = leftover[nid];
    for (int p : g.nodes[nid].preds) {
      const int len_p = (int)g.nodes[p].seq.size();
      const int r0 = std::max(0, len_p - a);
      const int left = a - (len_p - r0);
      if ((*row0)[p] < 0 || r0 < (*row0)[p]) (*row0)[p] = r0;
      if (left > leftover[p]) leftover[p] = left;
    }
  }
}

// Pure-diagonal traceback for perfect-score reads (score ==
// read_len * kMatch): such an alignment contains only matches, so the
// in-node walk is a forced diagonal and node boundaries are crossed to
// the first predecessor (in the same preds order trace_back uses) whose
// remaining read prefix also aligns perfectly -- exactly the
// H(pred,last,k-1) == k relation trace_back tests, without any fill.
// Returns false on any inconsistency (caller falls back to the banded
// fill+trace).
bool exact_trace(const GraphCtx& g, int node, int ref_pos, int k,
                 const char* read, std::vector<int>* nodes,
                 std::vector<int>* runs) {
  int run = 0;
  const std::string& seq = g.nodes[(size_t)node].seq;
  while (k >= 0 && ref_pos >= 0) {
    const char rc = seq[(size_t)ref_pos];
    if (rc != read[k] || nt_class(rc) >= 4) return false;
    --ref_pos;
    --k;
    ++run;
  }
  if (k < 0) {
    nodes->push_back(node);
    runs->push_back(run);
    return true;
  }
  for (int p : g.nodes[(size_t)node].preds) {
    const int last = (int)g.nodes[(size_t)p].seq.size() - 1;
    if (exact_trace(g, p, last, k, read, nodes, runs)) {
      nodes->push_back(node);
      runs->push_back(run);
      return true;
    }
  }
  return false;
}

std::string cigar_string(const Mapping& gm) {
  std::string out;
  char buf[32];
  for (size_t k = 0; k < gm.node_ids.size(); ++k) {
    snprintf(buf, sizeof(buf), "%d[", gm.node_ids[k]);
    out += buf;
    for (const CigOp& op : gm.cigars[k]) {
      snprintf(buf, sizeof(buf), "%d%c", op.len, op.op);
      out += buf;
    }
    out += "]";
  }
  return out;
}

}  // namespace

extern "C" {

void* gsw_create(int n_nodes, const char** seqs, const int* pred_offsets,
                 const int* preds) {
  GraphCtx* g = new GraphCtx();
  g->nodes.resize((size_t)n_nodes);
  for (int i = 0; i < n_nodes; ++i) {
    Node& node = g->nodes[(size_t)i];
    node.seq = seqs[i];
    for (char& c : node.seq) c = (char)toupper((unsigned char)c);
    for (int k = pred_offsets[i]; k < pred_offsets[i + 1]; ++k) {
      node.preds.push_back(preds[k]);
    }
    std::sort(node.preds.begin(), node.preds.end());
  }
  return g;
}

void gsw_destroy(void* ctx) {
  GraphCtx* g = (GraphCtx*)ctx;
  delete (FillResult*)g->scratch;
  delete g;
}

FillResult* ctx_scratch(GraphCtx* g) {
  if (!g->scratch) g->scratch = new FillResult();
  return (FillResult*)g->scratch;
}

// Fill + traceback + uniqueness on one read. Returns 0 on success.
// cigar_buf receives the node-CIGAR string ("0[4S10M]1[...]").
int gsw_align(void* ctx, const char* read, int read_len, int* score,
              int* position, int* multi, char* cigar_buf,
              int cigar_buf_size) {
  GraphCtx* g = (GraphCtx*)ctx;
  std::string upper(read, (size_t)read_len);
  for (char& c : upper) c = (char)toupper((unsigned char)c);
  FillResult& r = *ctx_scratch(g);
  fill_graph(*g, upper.c_str(), read_len, &r);
  Mapping gm;
  if (!trace_back(*g, r, upper.c_str(), &gm)) return -3;
  *score = r.max_score;
  *position = gm.position;
  *multi = ends_at_multiple_nodes(r) ? 1 : 0;
  std::string cig = cigar_string(gm);
  if ((int)cig.size() + 1 > cigar_buf_size) return -1;
  memcpy(cigar_buf, cig.c_str(), cig.size() + 1);
  return 0;
}

// Banded fill + traceback from a device-supplied end cell: fills only a
// 2*read_len+64-column band of node-row suffixes reachable backwards from
// (end_node, end_ref) and walks the CIGAR from (end_ref, end_read). The
// band is exact whenever the optimal path lies inside it, which is
// verified by comparing the banded H at the end cell against
// `expected_score` (the device kernel's tie-broken global max, already
// validated cell-exact vs the full fill). Any mismatch or stuck walk
// returns -2 and the caller re-runs the full-width gsw_align.
// Uniqueness is NOT computed here — the device already reports it.
int gsw_align_at(void* ctx, const char* read, int read_len, int end_node,
                 int end_ref, int end_read, int expected_score, int* score,
                 int* position, char* cigar_buf, int cigar_buf_size) {
  GraphCtx* g = (GraphCtx*)ctx;
  if (end_node < 0 || end_node >= (int)g->nodes.size() || end_ref < 0 ||
      end_read < 0 || end_read >= read_len || expected_score <= 0 ||
      end_ref >= (int)g->nodes[(size_t)end_node].seq.size())
    return -2;
  std::string upper(read, (size_t)read_len);
  for (char& c : upper) c = (char)toupper((unsigned char)c);
  // Band budget from the score bound: the alignment's reference span is
  // <= 2*read_len - score (each deleted ref base costs >= kGapExtend=1
  // and matches contribute kMatch=1 each, so deletions D <= m - score
  // <= read_len - score, and span = m + x + D <= read_len + D). The +8
  // slack is free insurance; the expected-score check below still
  // catches any band miss and falls back to full width. Clamped low for
  // garbage scores (> kMatch*read_len is unattainable — the check below
  // will reject and the caller re-runs full width).
  const int budget = std::max(
      1, std::min(2 * read_len + 64, 2 * read_len - expected_score + 8));
  std::vector<int> window;
  compute_window(*g, end_node, end_ref, budget, &window);
  FillResult& r = *ctx_scratch(g);
  fill_graph(*g, upper.c_str(), read_len, &r, window.data(), end_node,
             end_ref);
  const NodeFill& ef = r.fills[(size_t)end_node];
  if (ef.row0 < 0 || end_ref < ef.row0) return -2;
  const int32_t got =
      ef.H[(size_t)(end_ref - ef.row0) * r.m_pad + end_read];
  if (got != expected_score) return -2;  // band too narrow: go full width
  Mapping gm;
  if (!trace_back(*g, r, upper.c_str(), &gm, end_node, end_ref, end_read))
    return -2;
  *score = gm.score;
  *position = gm.position;
  std::string cig = cigar_string(gm);
  if ((int)cig.size() + 1 > cigar_buf_size) return -1;
  memcpy(cigar_buf, cig.c_str(), cig.size() + 1);
  return 0;
}

// Batched banded traceback: one call aligns `n` reads from their
// device-reported end cells, fanned out over `n_threads` native threads
// (the per-read work is independent; each thread owns its own scratch).
// reads are concatenated in `reads_concat` with prefix offsets
// `read_offs[n+1]`. Outputs: per-read rc (0 ok, -2 = caller must rerun
// full width), score, position, and the CIGAR written into
// `cigar_buf + i * cigar_stride` (rc -1 on overflow).
// ops_buf (optional, int32 stride ops_stride per read) receives the
// decoded alignment as integers, saving the host a CIGAR re-parse:
//   [0] n_nodes, [1] position, then per node: node_id, n_ops,
//   n_ops x (len<<3 | opcode) with M=0 X=1 N=2 S=3 I=4 D=5.
// n_nodes is 0 whenever rc != 0 or the encoding would overflow.
int gsw_align_at_batch(void* ctx, const char* reads_concat,
                       const int64_t* read_offs, int n,
                       const int* end_nodes, const int* end_refs,
                       const int* end_reads, const int* expected_scores,
                       int n_threads, int* rcs, int* scores, int* positions,
                       char* cigar_buf, int cigar_stride,
                       int32_t* ops_buf, int ops_stride) {
  GraphCtx* g = (GraphCtx*)ctx;
  if (n <= 0) return 0;
  n_threads = std::max(1, std::min(n_threads, 16));
  std::vector<std::thread> pool;
  std::atomic<int> next{0};
  auto worker = [&]() {
    FillResult scratch;
    Mapping gm;
    std::string upper;
    std::vector<int> window;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      const char* read = reads_concat + read_offs[i];
      const int read_len = (int)(read_offs[i + 1] - read_offs[i]);
      const int end_node = end_nodes[i], end_ref = end_refs[i];
      const int end_read = end_reads[i], exp_score = expected_scores[i];
      char* cig_out = cigar_buf + (size_t)i * cigar_stride;
      cig_out[0] = '\0';
      if (end_node < 0 || end_node >= (int)g->nodes.size() ||
          end_ref < 0 || end_read < 0 || end_read >= read_len ||
          exp_score <= 0 ||
          end_ref >= (int)g->nodes[(size_t)end_node].seq.size()) {
        rcs[i] = -2;
        continue;
      }
      upper.assign(read, (size_t)read_len);
      for (char& c : upper) c = (char)toupper((unsigned char)c);
      if (exp_score == read_len * kMatch && end_read == read_len - 1) {
        std::vector<int> nodes, runs;
        if (exact_trace(*g, end_node, end_ref, read_len - 1,
                        upper.c_str(), &nodes, &runs)) {
          gm.node_ids = nodes;
          gm.cigars.clear();
          for (int r : runs) gm.cigars.push_back({{r, 'M'}});
          gm.score = exp_score;
          gm.position =
              nodes.size() == 1
                  ? end_ref - runs[0] + 1
                  : (int)g->nodes[(size_t)nodes[0]].seq.size() - runs[0];
          scores[i] = gm.score;
          positions[i] = gm.position;
          const std::string cig = cigar_string(gm);
          if ((int)cig.size() + 1 > cigar_stride) { rcs[i] = -1; continue; }
          memcpy(cig_out, cig.c_str(), cig.size() + 1);
          rcs[i] = 0;
          if (ops_buf != nullptr) {
            int32_t* o = ops_buf + (size_t)i * ops_stride;
            o[0] = 0;
            int w = 2;
            bool ok = true;
            for (size_t k = 0; k < nodes.size(); ++k) {
              if (w + 3 > ops_stride) { ok = false; break; }
              o[w++] = nodes[k];
              o[w++] = 1;
              o[w++] = (runs[k] << 3) | 0;  // 'M' opcode
            }
            if (ok) {
              o[0] = (int32_t)nodes.size();
              o[1] = gm.position;
            }
          }
          continue;
        }
      }
      const int budget = std::max(
          1, std::min(2 * read_len + 64, 2 * read_len - exp_score + 8));
      compute_window(*g, end_node, end_ref, budget, &window);
      fill_graph(*g, upper.c_str(), read_len, &scratch, window.data(),
                 end_node, end_ref);
      const NodeFill& ef = scratch.fills[(size_t)end_node];
      if (ef.row0 < 0 || end_ref < ef.row0) { rcs[i] = -2; continue; }
      const int32_t got =
          ef.H[(size_t)(end_ref - ef.row0) * scratch.m_pad + end_read];
      if (got != exp_score) { rcs[i] = -2; continue; }
      gm.node_ids.clear();
      gm.cigars.clear();
      if (!trace_back(*g, scratch, upper.c_str(), &gm, end_node, end_ref,
                      end_read)) {
        rcs[i] = -2;
        continue;
      }
      scores[i] = gm.score;
      positions[i] = gm.position;
      const std::string cig = cigar_string(gm);
      if ((int)cig.size() + 1 > cigar_stride) { rcs[i] = -1; continue; }
      memcpy(cig_out, cig.c_str(), cig.size() + 1);
      rcs[i] = 0;
      if (ops_buf != nullptr) {
        int32_t* o = ops_buf + (size_t)i * ops_stride;
        o[0] = 0;
        int w = 2;
        bool ok = true;
        for (size_t k = 0; ok && k < gm.node_ids.size(); ++k) {
          if (w + 2 + (int)gm.cigars[k].size() > ops_stride) {
            ok = false;
            break;
          }
          o[w++] = gm.node_ids[k];
          o[w++] = (int32_t)gm.cigars[k].size();
          for (const CigOp& op : gm.cigars[k]) {
            int code;
            switch (op.op) {
              case 'M': code = 0; break;
              case 'X': code = 1; break;
              case 'N': code = 2; break;
              case 'S': code = 3; break;
              case 'I': code = 4; break;
              case 'D': code = 5; break;
              default: code = -1;
            }
            if (code < 0) { ok = false; break; }
            o[w++] = (op.len << 3) | code;
          }
        }
        if (ok) {
          o[0] = (int32_t)gm.node_ids.size();
          o[1] = gm.position;
        }
      }
    }
  };
  if (n_threads == 1 || n < 8) {
    worker();
  } else {
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return 0;
}

// Score-only fill (no traceback): returns max score and multi flag.
int gsw_score(void* ctx, const char* read, int read_len, int* score,
              int* multi) {
  GraphCtx* g = (GraphCtx*)ctx;
  std::string upper(read, (size_t)read_len);
  for (char& c : upper) c = (char)toupper((unsigned char)c);
  FillResult& r = *ctx_scratch(g);
  fill_graph(*g, upper.c_str(), read_len, &r);
  *score = r.max_score;
  *multi = ends_at_multiple_nodes(r) ? 1 : 0;
  return 0;
}

}  // extern "C"
