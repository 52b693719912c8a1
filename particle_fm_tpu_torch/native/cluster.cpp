// fastjet_lite: sequential-recombination jet clustering + substructure axes.
// The PyTorch port's copy of particle_fm_tpu/native/fastjet_lite/cluster.cpp,
// with two changes that leave every result the same: a pseudojet's rapidity
// is computed once, when its momentum is set (it was computed twice per pair
// per merge step), and a merged or promoted pseudojet leaves the list of
// candidates (which only grew). The candidates are visited in the same
// order, so the same pair wins every step.
//
// A compact C++ implementation of the generalized-kt family (anti-kt p=-1,
// Cambridge/Aachen p=0, kt p=1) with E-scheme or winner-take-all (WTA)
// recombination, plus exclusive-kt subjet axes for N-subjettiness.
//
// This replaces the reference's third-party fastjet/pyjet dependency
// (particle_fm/utils/jet_substructure.py:220-655, utils/lhco_utils.py:203-296)
// with an in-repo native component exposed through a C ABI for ctypes.
// O(n^2) per merge step / O(n^3) total — jets here have <= ~600 constituents,
// where the simple algorithm is faster than building fastjet's tiling
// structures.
//
// Build: particle_fm_tpu_torch/native/binding.py (g++ -O3 -shared -fPIC) into
// build/native/ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <utility>
#include <vector>

namespace {

struct PJ {
  double px, py, pz, e;    // four-momentum (E-scheme bookkeeping)
  double pt, eta, phi;     // cached hadronic coordinates
  double y;                // cached rapidity
  bool alive;

  void refresh() {
    pt = std::sqrt(px * px + py * py);
    double p = std::sqrt(px * px + py * py + pz * pz);
    eta = 0.5 * std::log(std::max(p + pz, 1e-300) / std::max(p - pz, 1e-300));
    phi = std::atan2(py, px);
    y = rapidity();
  }
  double mass() const {
    double m2 = e * e - px * px - py * py - pz * pz;
    return (m2 >= 0 ? std::sqrt(m2) : -std::sqrt(-m2));
  }
  double rapidity() const {
    return 0.5 * std::log(std::max(e + pz, 1e-300) / std::max(e - pz, 1e-300));
  }
};

inline double delta_phi(double a, double b) {
  double d = a - b;
  while (d > M_PI) d -= 2 * M_PI;
  while (d < -M_PI) d += 2 * M_PI;
  return d;
}

inline double dr2(const PJ& a, const PJ& b) {
  double de = a.y - b.y;
  double dp = delta_phi(a.phi, b.phi);
  return de * de + dp * dp;
}

inline double pow2p(double pt, double p) {
  if (p == -1.0) return 1.0 / (pt * pt);
  if (p == 0.0) return 1.0;
  if (p == 1.0) return pt * pt;
  return std::pow(pt, 2.0 * p);
}

PJ make_pj(double pt, double eta, double phi, double m) {
  PJ j;
  double et = std::sqrt(pt * pt + m * m);
  j.px = pt * std::cos(phi);
  j.py = pt * std::sin(phi);
  j.pz = et * std::sinh(eta);
  j.e = et * std::cosh(eta);
  j.alive = true;
  j.refresh();
  return j;
}

// E-scheme (wta=false) or winner-take-all (wta=true) recombination.
PJ combine(const PJ& a, const PJ& b, bool wta) {
  PJ c;
  if (!wta) {
    c.px = a.px + b.px;
    c.py = a.py + b.py;
    c.pz = a.pz + b.pz;
    c.e = a.e + b.e;
    c.alive = true;
    c.refresh();
    return c;
  }
  // WTA: direction of the harder constituent, scalar-pt sum, massless
  const PJ& hard = (a.pt >= b.pt) ? a : b;
  double pt = a.pt + b.pt;
  c = make_pj(pt, hard.eta, hard.phi, 0.0);
  return c;
}

// drop the pseudojets that are no longer alive, keeping the order
inline void compact(std::vector<int>& alive_idx, const std::vector<PJ>& pj) {
  alive_idx.erase(std::remove_if(alive_idx.begin(), alive_idx.end(),
                                 [&](int i) { return !pj[i].alive; }),
                  alive_idx.end());
}

struct ClusterState {
  std::vector<PJ> pj;
  std::vector<int> parent;  // union-find for constituent assignment
  int find(int i) {
    while (parent[i] != i) { parent[i] = parent[parent[i]]; i = parent[i]; }
    return i;
  }
};

// run the sequential recombination; returns indices of final pseudojets
// (inclusive: everything promoted to a jet via diB; exclusive: stop at njets)
void run_clustering(ClusterState& st, double R, double p, bool wta,
                    int exclusive_njets, std::vector<int>& final_idx) {
  const double R2 = R * R;
  int n_alive = 0;
  for (auto& j : st.pj) if (j.alive) n_alive++;

  std::vector<int> alive_idx;
  for (size_t i = 0; i < st.pj.size(); i++) if (st.pj[i].alive) alive_idx.push_back((int)i);

  while (n_alive > 0) {
    if (exclusive_njets > 0 && n_alive <= exclusive_njets) break;
    double best = std::numeric_limits<double>::infinity();
    int bi = -1, bj = -1;  // bj == -1 => beam merge
    for (size_t a = 0; a < alive_idx.size(); a++) {
      int i = alive_idx[a];
      if (!st.pj[i].alive) continue;
      double diB = pow2p(st.pj[i].pt, p);
      if (exclusive_njets <= 0 && diB < best) { best = diB; bi = i; bj = -1; }
      for (size_t b = a + 1; b < alive_idx.size(); b++) {
        int j = alive_idx[b];
        if (!st.pj[j].alive) continue;
        double dij = std::min(pow2p(st.pj[i].pt, p), pow2p(st.pj[j].pt, p)) *
                     dr2(st.pj[i], st.pj[j]) / R2;
        if (dij < best) { best = dij; bi = i; bj = j; }
      }
    }
    if (bi < 0) break;
    if (bj < 0) {
      // beam: promote to final jet
      final_idx.push_back(bi);
      st.pj[bi].alive = false;
      compact(alive_idx, st.pj);
      n_alive--;
    } else {
      PJ merged = combine(st.pj[bi], st.pj[bj], wta);
      st.pj[bi].alive = false;
      st.pj[bj].alive = false;
      st.pj.push_back(merged);
      int ni = (int)st.pj.size() - 1;
      st.parent.push_back(ni);
      st.parent[st.find(bi)] = ni;
      st.parent[st.find(bj)] = ni;
      compact(alive_idx, st.pj);
      alive_idx.push_back(ni);
      n_alive--;
    }
  }
  // whatever is still alive is a final (exclusive) jet
  for (size_t i = 0; i < st.pj.size(); i++)
    if (st.pj[i].alive) final_idx.push_back((int)i);
}

}  // namespace

extern "C" {

// Cluster one event. Inputs: arrays of length n (pt, eta, phi; massless).
// Outputs: up to max_jets jets sorted by descending pt as (pt, y, phi, m)
// rows in jet_out, constituent ownership in const_jet (length n; -1 = none).
// Returns the number of jets found (clipped to max_jets for jet_out, but
// const_jet labels refer to the returned jets only).
int cluster_jets(const double* pt, const double* eta, const double* phi, int n,
                 double R, double p, double min_pt, int exclusive_njets,
                 double* jet_out, int* const_jet, int max_jets) {
  ClusterState st;
  st.pj.reserve(2 * n);
  st.parent.reserve(2 * n);
  for (int i = 0; i < n; i++) {
    if (pt[i] <= 0) continue;
    st.pj.push_back(make_pj(pt[i], eta[i], phi[i], 0.0));
    st.parent.push_back((int)st.pj.size() - 1);
  }
  // map from pseudojet index (initial) to input index
  std::vector<int> input_of;
  for (int i = 0; i < n; i++)
    if (pt[i] > 0) input_of.push_back(i);

  std::vector<int> final_idx;
  run_clustering(st, R, p, /*wta=*/false, exclusive_njets, final_idx);

  // sort final jets by pt desc, apply min_pt
  std::vector<std::pair<double, int>> order;
  for (int idx : final_idx)
    if (st.pj[idx].pt >= min_pt) order.push_back({-st.pj[idx].pt, idx});
  std::sort(order.begin(), order.end());

  int n_jets = std::min((int)order.size(), max_jets);
  for (int j = 0; j < n_jets; j++) {
    const PJ& J = st.pj[order[j].second];
    jet_out[4 * j + 0] = J.pt;
    jet_out[4 * j + 1] = J.rapidity();
    jet_out[4 * j + 2] = J.phi;
    jet_out[4 * j + 3] = J.mass();
  }
  for (int i = 0; i < n; i++) const_jet[i] = -1;
  for (size_t k = 0; k < input_of.size(); k++) {
    int root = st.find((int)k);
    for (int j = 0; j < n_jets; j++) {
      if (root == order[j].second) { const_jet[input_of[k]] = j; break; }
    }
  }
  return (int)order.size();
}

// Exclusive-kt axes for N-subjettiness (WTA recombination, like the
// reference's fastjet config "kt, WTA scheme", jet_substructure.py:563-655).
// Returns the number of axes written (<= n_axes); axes_out rows = (eta, phi).
int exclusive_kt_axes(const double* pt, const double* eta, const double* phi,
                      int n, double R, int n_axes, double* axes_out) {
  ClusterState st;
  st.pj.reserve(2 * n);
  st.parent.reserve(2 * n);
  for (int i = 0; i < n; i++) {
    if (pt[i] <= 0) continue;
    st.pj.push_back(make_pj(pt[i], eta[i], phi[i], 0.0));
    st.parent.push_back((int)st.pj.size() - 1);
  }
  if (st.pj.empty()) return 0;
  std::vector<int> final_idx;
  run_clustering(st, R, /*p=*/1.0, /*wta=*/true, n_axes, final_idx);
  int k = std::min((int)final_idx.size(), n_axes);
  // order by pt desc for deterministic output
  std::vector<std::pair<double, int>> order;
  for (int idx : final_idx) order.push_back({-st.pj[idx].pt, idx});
  std::sort(order.begin(), order.end());
  for (int a = 0; a < k; a++) {
    axes_out[2 * a + 0] = st.pj[order[a].second].rapidity();
    axes_out[2 * a + 1] = st.pj[order[a].second].phi;
  }
  return k;
}

// kt splitting scales: sqrt(dij * R^2) at the exclusive-kt merges that take
// the event from N->N-1 jets (d12 = the final 2->1 merge, d23 = 3->2, ...).
// Writes n_scales values (largest-N merge first missing scales = 0).
int kt_split_scales(const double* pt, const double* eta, const double* phi,
                    int n, double R, int n_scales, double* scales_out) {
  ClusterState st;
  st.pj.reserve(2 * n);
  st.parent.reserve(2 * n);
  for (int i = 0; i < n; i++) {
    if (pt[i] <= 0) continue;
    st.pj.push_back(make_pj(pt[i], eta[i], phi[i], 0.0));
    st.parent.push_back((int)st.pj.size() - 1);
  }
  for (int s = 0; s < n_scales; s++) scales_out[s] = 0.0;
  int n_alive = (int)st.pj.size();
  if (n_alive == 0) return 0;
  const double R2 = R * R;
  std::vector<int> alive_idx;
  for (size_t i = 0; i < st.pj.size(); i++) alive_idx.push_back((int)i);
  int written = 0;
  while (n_alive > 1) {
    double best = std::numeric_limits<double>::infinity();
    int bi = -1, bj = -1;
    for (size_t a = 0; a < alive_idx.size(); a++) {
      int i = alive_idx[a];
      if (!st.pj[i].alive) continue;
      for (size_t b = a + 1; b < alive_idx.size(); b++) {
        int j = alive_idx[b];
        if (!st.pj[j].alive) continue;
        double dij = std::min(pow2p(st.pj[i].pt, 1.0), pow2p(st.pj[j].pt, 1.0)) *
                     dr2(st.pj[i], st.pj[j]) / R2;
        if (dij < best) { best = dij; bi = i; bj = j; }
      }
    }
    if (bi < 0) break;
    // about to merge n_alive -> n_alive-1: if n_alive <= n_scales+1 record it
    if (n_alive - 1 <= n_scales) {
      scales_out[n_alive - 2] = std::sqrt(best * R2);  // d_{(k)(k+1)} with k = n_alive-1
      written++;
    }
    PJ merged = combine(st.pj[bi], st.pj[bj], /*wta=*/false);
    st.pj[bi].alive = false;
    st.pj[bj].alive = false;
    st.pj.push_back(merged);
    st.parent.push_back((int)st.pj.size() - 1);
    compact(alive_idx, st.pj);
    alive_idx.push_back((int)st.pj.size() - 1);
    n_alive--;
  }
  return written;
}

void kt_split_scales_events(const double* pt, const double* eta,
                            const double* phi, int n_events, int n_max,
                            double R, int n_scales, double* scales_out) {
  for (int e = 0; e < n_events; e++) {
    kt_split_scales(pt + (int64_t)e * n_max, eta + (int64_t)e * n_max,
                    phi + (int64_t)e * n_max, n_max, R, n_scales,
                    scales_out + (int64_t)e * n_scales);
  }
}

// Batched driver: events padded to n_max particles; zero-pt entries ignored.
void cluster_events(const double* pt, const double* eta, const double* phi,
                    int n_events, int n_max, double R, double p, double min_pt,
                    double* jets_out, int* njets_out, int* const_jet_out,
                    int max_jets) {
  for (int e = 0; e < n_events; e++) {
    njets_out[e] = cluster_jets(
        pt + (int64_t)e * n_max, eta + (int64_t)e * n_max, phi + (int64_t)e * n_max,
        n_max, R, p, min_pt, /*exclusive_njets=*/0,
        jets_out + (int64_t)e * max_jets * 4, const_jet_out + (int64_t)e * n_max,
        max_jets);
  }
}

void exclusive_kt_axes_events(const double* pt, const double* eta,
                              const double* phi, int n_events, int n_max,
                              double R, int n_axes, double* axes_out,
                              int* naxes_out) {
  for (int e = 0; e < n_events; e++) {
    naxes_out[e] = exclusive_kt_axes(
        pt + (int64_t)e * n_max, eta + (int64_t)e * n_max, phi + (int64_t)e * n_max,
        n_max, R, n_axes, axes_out + (int64_t)e * n_axes * 2);
  }
}

}  // extern "C"
