// Native chemistry kernel: SMILES parse + sanitize + dense featurization.
//
// The reference's dataset cold start is dominated by per-molecule RDKit
// parsing + featurization over 1.6M ChEMBL SMILES (reference
// src/data/dataset.py:280-317, SURVEY.md §3.3).  RDKit's speed comes from
// its C++ core; this file is our equivalent: a multithreaded C++
// implementation of exactly the semantics of druggen_tpu/chem
// (smiles.py + mol.py sanitize + codec.py featurize), exposed through a
// C ABI consumed via ctypes (druggen_tpu/native/__init__.py).
//
// Output contract: dg_featurize produces bit-identical (X, A) int8 label
// matrices to the Python path (cross-validated in tests/test_native.py).
//
// Build: make -C druggen_tpu/native   (produces libdruggen_chem.so)

#include <algorithm>
#include <array>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <functional>
#include <map>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------- element data
// Mirrors druggen_tpu/chem/periodic.py

struct ElementInfo {
  const char* sym;
  int num;
};

const ElementInfo kTwoLetter[] = {
    {"He", 2},  {"Li", 3},  {"Be", 4},  {"Ne", 10}, {"Na", 11}, {"Mg", 12},
    {"Al", 13}, {"Si", 14}, {"Cl", 17}, {"Ar", 18}, {"Ca", 20}, {"Sc", 21},
    {"Ti", 22}, {"Cr", 24}, {"Mn", 25}, {"Fe", 26}, {"Co", 27}, {"Ni", 28},
    {"Cu", 29}, {"Zn", 30}, {"Ga", 31}, {"Ge", 32}, {"As", 33}, {"Se", 34},
    {"Br", 35}, {"Kr", 36}, {"Rb", 37}, {"Sr", 38}, {"Zr", 40}, {"Nb", 41},
    {"Mo", 42}, {"Tc", 43}, {"Ru", 44}, {"Rh", 45}, {"Pd", 46}, {"Ag", 47},
    {"Cd", 48}, {"In", 49}, {"Sn", 50}, {"Sb", 51}, {"Te", 52}, {"Xe", 54},
    {"Cs", 55}, {"Ba", 56}, {"La", 57}, {"Gd", 64}, {"Pt", 78}, {"Au", 79},
    {"Hg", 80}, {"Tl", 81}, {"Pb", 82}, {"Bi", 83}};

int one_letter_num(char c) {
  switch (c) {
    case 'H': return 1;
    case 'B': return 5;
    case 'C': return 6;
    case 'N': return 7;
    case 'O': return 8;
    case 'F': return 9;
    case 'P': return 15;
    case 'S': return 16;
    case 'K': return 19;
    case 'V': return 23;
    case 'Y': return 39;
    case 'I': return 53;
    case 'W': return 74;
    default: return -1;
  }
}

int symbol_to_num(const std::string& s) {
  if (s.size() == 2) {
    for (const auto& e : kTwoLetter)
      if (s == e.sym) return e.num;
    return -1;
  }
  if (s.size() == 1) return one_letter_num(s[0]);
  return -1;
}

// default valence lists (smallest first); same table as periodic.py
const std::map<int, std::vector<int>>& default_valences() {
  static const std::map<int, std::vector<int>> v = {
      {1, {1}},  {5, {3}},       {6, {4}},      {7, {3}},  {8, {2}},
      {9, {1}},  {14, {4}},      {15, {3, 5}},  {16, {2, 4, 6}},
      {17, {1}}, {33, {3, 5}},   {34, {2, 4, 6}}, {35, {1}}, {53, {1}}};
  return v;
}

bool is_aromatic_element(int z) {
  return z == 5 || z == 6 || z == 7 || z == 8 || z == 15 || z == 16 ||
         z == 33 || z == 34;
}

// charge-adjusted default valence; -1 => no implicit-H model
int default_valence(int z, double ev, int charge) {
  auto it = default_valences().find(z);
  if (it == default_valences().end()) return -1;
  std::vector<int> adjusted;
  for (int v : it->second) {
    int a = v;
    if (z == 7 || z == 15 || z == 33 || z == 8 || z == 16 || z == 34)
      a = v + charge;
    else if (z == 6)
      a = v - std::abs(charge);
    else if (z == 5)
      a = v - charge;
    else if (z == 9 || z == 17 || z == 35 || z == 53 || z == 1)
      a = v + charge;
    adjusted.push_back(a);
  }
  std::sort(adjusted.begin(), adjusted.end());
  for (int v : adjusted)
    if (v >= ev - 1e-9 && v >= 0) return v;
  return -1;
}

int max_allowed_valence(int z, int charge) {
  auto it = default_valences().find(z);
  if (it == default_valences().end()) return -1;
  int top = it->second.back();
  if (z == 7 || z == 15 || z == 33 || z == 8 || z == 16 || z == 34)
    top += charge;
  else if (z == 6)
    top -= std::abs(charge);
  else if (z == 5)
    top -= charge;
  else if (z == 17 || z == 35 || z == 53)
    return 7;  // hypervalent halogens allowed (matches periodic.py)
  return top < 0 ? 0 : top;
}

// ----------------------------------------------------------- molecule

struct Atom {
  int z = 0;
  int charge = 0;
  bool aromatic = false;
  int explicit_hs = -1;  // -1 => implicit
  int implicit_hs = 0;
  bool in_ring = false;
};

// bond type ints match chem.mol.BondType
enum BondT { ZERO = 0, SINGLE = 1, DOUBLE = 2, TRIPLE = 3, AROMATIC = 4 };

struct Bond {
  int a1, a2;
  int type;
};

struct Mol {
  std::vector<Atom> atoms;
  std::vector<Bond> bonds;
  std::vector<std::vector<int>> adj;  // atom -> bond indices

  void build_adj() {
    adj.assign(atoms.size(), {});
    for (size_t bi = 0; bi < bonds.size(); ++bi) {
      adj[bonds[bi].a1].push_back((int)bi);
      adj[bonds[bi].a2].push_back((int)bi);
    }
  }
  int other(int bi, int i) const {
    return bonds[bi].a1 == i ? bonds[bi].a2 : bonds[bi].a1;
  }
  const Bond* find_bond(int a, int b) const {
    for (int bi : adj[a])
      if (other(bi, a) == b) return &bonds[bi];
    return nullptr;
  }
};

// ----------------------------------------------------------- parser
// Mirrors druggen_tpu/chem/smiles.py

struct Parser {
  const std::string& s;
  size_t i = 0;
  Mol mol;
  bool ok = true;

  explicit Parser(const std::string& str) : s(str) {}

  bool fail() {
    ok = false;
    return false;
  }

  bool parse_bracket(Atom* out) {
    size_t close = s.find(']', i);
    if (close == std::string::npos) return fail();
    std::string body = s.substr(i + 1, close - i - 1);
    size_t k = 0, n = body.size();
    while (k < n && isdigit((unsigned char)body[k])) ++k;  // isotope dropped
    if (k >= n) return fail();
    Atom a;
    if (body.compare(k, 2, "se") == 0 || body.compare(k, 2, "as") == 0) {
      a.z = body[k] == 's' ? 34 : 33;
      a.aromatic = true;
      k += 2;
    } else if (islower((unsigned char)body[k]) &&
               std::string("bcnops").find(body[k]) != std::string::npos) {
      std::string up(1, (char)toupper(body[k]));
      a.z = symbol_to_num(up);
      a.aromatic = true;
      ++k;
    } else if (body[k] == '*') {
      a.z = 0;
      ++k;
    } else {
      if (k + 1 < n && islower((unsigned char)body[k + 1]) &&
          symbol_to_num(body.substr(k, 2)) > 0) {
        a.z = symbol_to_num(body.substr(k, 2));
        k += 2;
      } else {
        a.z = symbol_to_num(body.substr(k, 1));
        ++k;
      }
      if (a.z < 0) return fail();
    }
    while (k < n && body[k] == '@') {  // chirality dropped
      ++k;
      if (k + 1 < n) {
        std::string two = body.substr(k, 2);
        if (two == "TH" || two == "AL" || two == "SP" || two == "TB" ||
            two == "OH") {
          k += 2;
          while (k < n && isdigit((unsigned char)body[k])) ++k;
        }
      }
    }
    a.explicit_hs = 0;
    if (k < n && body[k] == 'H') {
      ++k;
      a.explicit_hs = 1;
      std::string num;
      while (k < n && isdigit((unsigned char)body[k])) num += body[k++];
      if (!num.empty()) a.explicit_hs = std::stoi(num);
    }
    while (k < n && (body[k] == '+' || body[k] == '-')) {
      int sign = body[k] == '+' ? 1 : -1;
      ++k;
      std::string num;
      while (k < n && isdigit((unsigned char)body[k])) num += body[k++];
      if (!num.empty()) {
        a.charge += sign * std::stoi(num);
      } else {
        a.charge += sign;
        while (k < n && body[k] == (sign > 0 ? '+' : '-')) {
          a.charge += sign;
          ++k;
        }
      }
    }
    if (k < n && body[k] == ':') {  // atom map dropped
      ++k;
      if (k >= n || !isdigit((unsigned char)body[k])) return fail();
      while (k < n && isdigit((unsigned char)body[k])) ++k;
    }
    if (k != n) return fail();
    *out = a;
    i = close + 1;
    return true;
  }

  bool add_bond(int a1, int a2, int type) {
    if (a1 == a2) return fail();
    for (const auto& b : mol.bonds)
      if ((b.a1 == a1 && b.a2 == a2) || (b.a1 == a2 && b.a2 == a1))
        return fail();
    mol.bonds.push_back({a1, a2, type});
    return true;
  }

  bool run() {
    int prev = -1;
    int pending = -1;  // -1 none, else BondT
    std::vector<std::pair<int, int>> branch;         // (prev, pending)
    std::map<int, std::pair<int, int>> ring_open;    // num -> (atom, bond)
    size_t n = s.size();
    while (i < n && ok) {
      char c = s[i];
      Atom atom;
      bool have_atom = false;
      if (c == '[') {
        if (!parse_bracket(&atom)) return false;
        have_atom = true;
      } else if ((c == 'C' && i + 1 < n && s[i + 1] == 'l') ||
                 (c == 'B' && i + 1 < n && s[i + 1] == 'r')) {
        atom.z = c == 'C' ? 17 : 35;
        i += 2;
        have_atom = true;
      } else if (std::string("BCNOPSFI").find(c) != std::string::npos) {
        atom.z = one_letter_num(c);
        ++i;
        have_atom = true;
      } else if (std::string("bcnops").find(c) != std::string::npos) {
        std::string up(1, (char)toupper(c));
        atom.z = symbol_to_num(up);
        atom.aromatic = true;
        ++i;
        have_atom = true;
      } else if (c == '*') {
        atom.z = 0;
        ++i;
        have_atom = true;
      } else if (c == '-' || c == '=' || c == '#' || c == ':' || c == '/' ||
                 c == '\\') {
        int bt = c == '=' ? DOUBLE : c == '#' ? TRIPLE
                 : c == ':' ? AROMATIC : SINGLE;
        if (pending != -1 && c != '/' && c != '\\') return fail();
        pending = bt;
        ++i;
        continue;
      } else if (c == '(') {
        if (prev < 0) return fail();
        branch.push_back({prev, pending});
        pending = -1;
        ++i;
        continue;
      } else if (c == ')') {
        if (branch.empty()) return fail();
        prev = branch.back().first;
        branch.pop_back();
        pending = -1;
        ++i;
        continue;
      } else if (c == '.') {
        prev = -1;
        pending = -1;
        ++i;
        continue;
      } else if (isdigit((unsigned char)c) || c == '%') {
        if (prev < 0) return fail();
        int num;
        if (c == '%') {
          if (i + 2 >= n || !isdigit((unsigned char)s[i + 1]) ||
              !isdigit((unsigned char)s[i + 2]))
            return fail();
          num = (s[i + 1] - '0') * 10 + (s[i + 2] - '0');
          i += 3;
        } else {
          num = c - '0';
          ++i;
        }
        auto it = ring_open.find(num);
        if (it != ring_open.end()) {
          int opost = it->second.first;
          int obond = it->second.second;
          ring_open.erase(it);
          if (opost == prev) return fail();
          int bt = pending != -1 ? pending : obond;
          if (pending != -1 && obond != -1 && pending != obond) return fail();
          if (bt == -1)
            bt = (mol.atoms[opost].aromatic && mol.atoms[prev].aromatic)
                     ? AROMATIC
                     : SINGLE;
          if (!add_bond(opost, prev, bt)) return false;
        } else {
          ring_open[num] = {prev, pending};
        }
        pending = -1;
        continue;
      } else {
        return fail();
      }
      if (have_atom) {
        if (atom.z < 0) return fail();
        mol.atoms.push_back(atom);
        int idx = (int)mol.atoms.size() - 1;
        if (prev >= 0) {
          int bt = pending;
          if (bt == -1)
            bt = (mol.atoms[prev].aromatic && atom.aromatic) ? AROMATIC
                                                             : SINGLE;
          if (!add_bond(prev, idx, bt)) return false;
        }
        prev = idx;
        pending = -1;
      }
    }
    if (!branch.empty() || !ring_open.empty() || pending != -1) return fail();
    if (mol.atoms.empty()) return fail();
    return ok;
  }
};

// ----------------------------------------------------------- rings (SSSR)
// Mirrors Mol.ring_info (Horton-style smallest rings + GF(2) basis).

std::vector<int> smallest_cycle_through(const Mol& m, int u, int v) {
  int n = (int)m.atoms.size();
  std::vector<int> prev(n, -1);
  std::vector<char> seen(n, 0);
  seen[u] = 1;
  std::vector<int> q = {u};
  while (!q.empty() && !seen[v]) {
    std::vector<int> nq;
    for (int x : q)
      for (int bi : m.adj[x]) {
        int y = m.other(bi, x);
        if (x == u && y == v) continue;
        if (!seen[y]) {
          seen[y] = 1;
          prev[y] = x;
          nq.push_back(y);
        }
      }
    q.swap(nq);
  }
  if (!seen[v]) return {};
  std::vector<int> path = {v};
  while (path.back() != u) path.push_back(prev[path.back()]);
  return path;
}

std::vector<std::vector<int>> ring_info(const Mol& m) {
  int n = (int)m.atoms.size();
  int nb = (int)m.bonds.size();
  if (nb == 0) return {};
  // connected components
  std::vector<char> seen(n, 0);
  int comps = 0;
  for (int s0 = 0; s0 < n; ++s0) {
    if (seen[s0]) continue;
    ++comps;
    std::vector<int> st = {s0};
    seen[s0] = 1;
    while (!st.empty()) {
      int u = st.back();
      st.pop_back();
      for (int bi : m.adj[u]) {
        int v = m.other(bi, u);
        if (!seen[v]) {
          seen[v] = 1;
          st.push_back(v);
        }
      }
    }
  }
  int cyclomatic = nb - n + comps;
  if (cyclomatic <= 0) return {};

  std::map<std::pair<int, int>, int> bond_index;
  for (int bi = 0; bi < nb; ++bi) {
    int a = std::min(m.bonds[bi].a1, m.bonds[bi].a2);
    int b = std::max(m.bonds[bi].a1, m.bonds[bi].a2);
    bond_index[{a, b}] = bi;
  }

  struct Cand {
    int size;
    std::vector<uint64_t> mask;  // bitset over bonds
    std::vector<int> cyc;
  };
  std::vector<Cand> cands;
  std::set<std::vector<uint64_t>> seen_rings;
  int words = (nb + 63) / 64;
  for (const auto& b : m.bonds) {
    auto cyc = smallest_cycle_through(m, b.a1, b.a2);
    if (cyc.empty()) continue;
    std::vector<uint64_t> mask(words, 0);
    bool good = true;
    for (size_t idx = 0; idx < cyc.size(); ++idx) {
      int x = cyc[idx], y = cyc[(idx + 1) % cyc.size()];
      auto it = bond_index.find({std::min(x, y), std::max(x, y)});
      if (it == bond_index.end()) {
        good = false;
        break;
      }
      mask[it->second / 64] |= 1ull << (it->second % 64);
    }
    if (good && seen_rings.insert(mask).second)
      cands.push_back({(int)cyc.size(), mask, cyc});
  }
  std::stable_sort(cands.begin(), cands.end(),
                   [](const Cand& a, const Cand& b) { return a.size < b.size; });

  auto top_bit = [&](const std::vector<uint64_t>& v) {
    for (int w = words - 1; w >= 0; --w)
      if (v[w]) return w * 64 + 63 - __builtin_clzll(v[w]);
    return -1;
  };
  std::map<int, std::vector<uint64_t>> basis;
  std::vector<std::vector<int>> chosen;
  for (auto& c : cands) {
    std::vector<uint64_t> v = c.mask;
    while (true) {
      int h = top_bit(v);
      if (h < 0) break;
      auto it = basis.find(h);
      if (it == basis.end()) {
        basis[h] = v;
        chosen.push_back(c.cyc);
        break;
      }
      for (int w = 0; w < words; ++w) v[w] ^= it->second[w];
    }
    if ((int)chosen.size() == cyclomatic) break;
  }
  return chosen;
}

// ----------------------------------------------------------- sanitize
// Mirrors Mol.sanitize: aromatic checks, kekulize, Hückel, implicit H,
// valence check.  Returns kekulé double-bond set for valence accounting.

struct SanitizeResult {
  bool ok = false;
  std::set<std::pair<int, int>> kekule_double;
};

bool contributes_lone_pair(const Mol& m, int i) {
  const Atom& a = m.atoms[i];
  if (a.z == 8 || a.z == 16 || a.z == 34) return true;
  if (a.z == 7 || a.z == 15 || a.z == 33) {
    if (a.explicit_hs > 0) return true;
    if (a.charge == 0 && m.adj[i].size() == 3) return true;
    if (a.charge == -1) return true;
  }
  if (a.z == 6 && a.charge == -1) return true;
  return false;
}

bool kekulize(Mol& m, std::set<std::pair<int, int>>* out) {
  std::vector<int> needs;
  for (int i = 0; i < (int)m.atoms.size(); ++i) {
    if (!m.atoms[i].aromatic) continue;
    if (contributes_lone_pair(m, i)) continue;
    bool has_double = false;
    for (int bi : m.adj[i])
      if (m.bonds[bi].type == DOUBLE) has_double = true;
    if (!has_double) needs.push_back(i);
  }
  std::set<int> need_set(needs.begin(), needs.end());
  std::map<int, std::vector<int>> nbrs;
  for (int i : needs) {
    for (int bi : m.adj[i]) {
      int j = m.other(bi, i);
      if (need_set.count(j) && m.bonds[bi].type == AROMATIC)
        nbrs[i].push_back(j);
    }
  }
  std::map<int, int> matched;
  long budget = 200000;

  std::function<bool(const std::vector<int>&)> backtrack =
      [&](const std::vector<int>& remaining) -> bool {
    if (remaining.empty()) return true;
    if (--budget < 0) return false;
    int u = remaining[0];
    for (int v : nbrs[u]) {
      if (matched.count(v)) continue;
      matched[u] = v;
      matched[v] = u;
      std::vector<int> rest;
      for (size_t k = 1; k < remaining.size(); ++k)
        if (remaining[k] != v) rest.push_back(remaining[k]);
      if (backtrack(rest)) return true;
      matched.erase(u);
      matched.erase(v);
    }
    return false;
  };
  if (!backtrack(needs)) return false;
  for (auto& kv : matched) {
    int a = std::min(kv.first, kv.second), b = std::max(kv.first, kv.second);
    out->insert({a, b});
  }
  return true;
}

double explicit_valence(const Mol& m, int i,
                        const std::set<std::pair<int, int>>& kek) {
  double v = 0;
  for (int bi : m.adj[i]) {
    const Bond& b = m.bonds[bi];
    if (b.type == AROMATIC) {
      int a = std::min(b.a1, b.a2), c = std::max(b.a1, b.a2);
      v += kek.count({a, c}) ? 2.0 : 1.0;
    } else {
      v += b.type == SINGLE ? 1.0 : b.type == DOUBLE ? 2.0
           : b.type == TRIPLE ? 3.0 : 0.0;
    }
  }
  if (m.atoms[i].explicit_hs >= 0) v += m.atoms[i].explicit_hs;
  return v;
}

bool huckel_check(const Mol& m, const std::set<std::pair<int, int>>& kek,
                  const std::vector<std::vector<int>>& rings) {
  int n = (int)m.atoms.size();
  std::vector<int> comp(n, -1);
  int c = 0;
  for (int i = 0; i < n; ++i) {
    if (!m.atoms[i].aromatic || comp[i] != -1) continue;
    std::vector<int> st = {i};
    comp[i] = c;
    while (!st.empty()) {
      int u = st.back();
      st.pop_back();
      for (int bi : m.adj[u]) {
        if (m.bonds[bi].type != AROMATIC) continue;
        int v = m.other(bi, u);
        if (m.atoms[v].aromatic && comp[v] == -1) {
          comp[v] = c;
          st.push_back(v);
        }
      }
    }
    ++c;
  }
  if (c == 0) return true;

  auto pi = [&](int i) -> int {
    if (contributes_lone_pair(m, i)) return 2;
    for (int bi : m.adj[i]) {
      const Bond& b = m.bonds[bi];
      int j = m.other(bi, i);
      if (b.type == DOUBLE && m.atoms[j].aromatic) return 1;
      if (b.type == AROMATIC) {
        int a = std::min(b.a1, b.a2), d = std::max(b.a1, b.a2);
        if (kek.count({a, d})) return 1;
      }
    }
    return 0;
  };

  for (int ci = 0; ci < c; ++ci) {
    std::vector<int> members;
    for (int i = 0; i < n; ++i)
      if (comp[i] == ci) members.push_back(i);
    int total = 0;
    for (int i : members) total += pi(i);
    bool okc = total % 4 == 2;
    if (!okc) {
      std::set<int> mset(members.begin(), members.end());
      for (const auto& r : rings) {
        bool inside = true;
        for (int x : r)
          if (!mset.count(x)) inside = false;
        if (!inside) continue;
        int rt = 0;
        for (int x : r) rt += pi(x);
        if (rt % 4 == 2) {
          okc = true;
          break;
        }
      }
    }
    if (!okc) return false;
  }
  return true;
}

SanitizeResult sanitize(Mol& m) {
  SanitizeResult res;
  m.build_adj();
  auto rings = ring_info(m);
  for (auto& a : m.atoms) a.in_ring = false;
  for (const auto& r : rings)
    for (int i : r) m.atoms[i].in_ring = true;

  for (const auto& b : m.bonds) {
    if (b.type == AROMATIC) {
      if (!(m.atoms[b.a1].in_ring && m.atoms[b.a2].in_ring)) return res;
      m.atoms[b.a1].aromatic = true;
      m.atoms[b.a2].aromatic = true;
    }
  }
  for (int i = 0; i < (int)m.atoms.size(); ++i) {
    const Atom& a = m.atoms[i];
    if (a.aromatic) {
      if (!a.in_ring) return res;
      if (!is_aromatic_element(a.z)) return res;
    }
  }
  if (!kekulize(m, &res.kekule_double)) return res;
  if (!huckel_check(m, res.kekule_double, rings)) return res;

  for (int i = 0; i < (int)m.atoms.size(); ++i) {
    Atom& a = m.atoms[i];
    double ev = explicit_valence(m, i, res.kekule_double);
    if (a.explicit_hs < 0) {
      int dv = default_valence(a.z, ev, a.charge);
      a.implicit_hs = dv < 0 ? 0 : std::max((int)std::lround(dv - ev), 0);
      if (a.aromatic && a.z == 7 && a.charge == 0) a.implicit_hs = 0;
    }
    double total = ev + (a.explicit_hs >= 0 ? 0 : a.implicit_hs);
    int mv = max_allowed_valence(a.z, a.charge);
    if (mv >= 0 && total > mv + 1e-6) return res;
  }
  res.ok = true;
  return res;
}

}  // namespace

// ----------------------------------------------------------- C ABI

extern "C" {

// Featurize one SMILES into int8 label matrices.
// atom_vocab: atomic numbers by index (index 0 = PAD 0);
// bond_vocab: BondType ints by index.
// Returns: n_atoms (>0) on success, 0 if filtered (size/vocab/connectivity),
// -1 on parse/sanitize failure.
int dg_featurize(const char* smiles, int max_atom, const int64_t* atom_vocab,
                 int n_atom_vocab, const int64_t* bond_vocab,
                 int n_bond_vocab, int8_t* X_out, int8_t* A_out) {
  std::string s(smiles);
  // take the first whitespace token
  size_t start = s.find_first_not_of(" \t\r\n");
  if (start == std::string::npos) return -1;
  size_t end = s.find_first_of(" \t\r\n", start);
  s = s.substr(start, end == std::string::npos ? end : end - start);
  if (s.empty()) return -1;

  Parser p(s);
  if (!p.run()) return -1;
  Mol& m = p.mol;
  auto res = sanitize(m);
  if (!res.ok) return -1;

  int n = (int)m.atoms.size();
  if (n > max_atom || n == 0) return 0;
  if (n == 1) return 0;  // single atom fails connectivity filter

  std::map<int, int> aenc, benc;
  for (int i = 0; i < n_atom_vocab; ++i) aenc[(int)atom_vocab[i]] = i;
  for (int i = 0; i < n_bond_vocab; ++i) benc[(int)bond_vocab[i]] = i;

  std::memset(X_out, 0, max_atom);
  std::memset(A_out, 0, (size_t)max_atom * max_atom);
  for (int i = 0; i < n; ++i) {
    auto it = aenc.find(m.atoms[i].z);
    if (it == aenc.end()) return 0;
    X_out[i] = (int8_t)it->second;
  }
  std::vector<int> degree(n, 0);
  for (const auto& b : m.bonds) {
    auto it = benc.find(b.type);
    if (it == benc.end()) return 0;
    A_out[b.a1 * max_atom + b.a2] = (int8_t)it->second;
    A_out[b.a2 * max_atom + b.a1] = (int8_t)it->second;
    ++degree[b.a1];
    ++degree[b.a2];
  }
  for (int i = 0; i < n; ++i)
    if (degree[i] == 0) return 0;  // connectivity filter
  return n;
}

// Batch featurization over a \n-separated SMILES buffer.
// keep[i] = n_atoms / 0 / -1 per input line.  Multithreaded.
void dg_featurize_batch(const char* buf, int64_t buf_len, int64_t n_lines,
                        const int64_t* line_offsets, int max_atom,
                        const int64_t* atom_vocab, int n_atom_vocab,
                        const int64_t* bond_vocab, int n_bond_vocab,
                        int8_t* X_out, int8_t* A_out, int32_t* keep,
                        int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_lines) break;
      int64_t off = line_offsets[i];
      int64_t end = (i + 1 < n_lines) ? line_offsets[i + 1] : buf_len;
      std::string line(buf + off, buf + end);
      keep[i] = dg_featurize(line.c_str(), max_atom, atom_vocab,
                             n_atom_vocab, bond_vocab, n_bond_vocab,
                             X_out + i * max_atom,
                             A_out + i * (int64_t)max_atom * max_atom);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Vocabulary scan over a \n-separated SMILES buffer (multithreaded).
// Mirrors druggen_tpu/chem/vocab.py build_vocab semantics (reference
// src/data/utils.py:83-109): keep molecules that parse+sanitize and have
// <= max_atom atoms (no connectivity filter here, unlike dg_featurize),
// union atomic numbers / bond-type ints into the output masks.
// atom_mask: 256 bytes; bond_mask: 64 bytes.  A set byte => label present.
void dg_vocab_scan(const char* buf, int64_t buf_len, int64_t n_lines,
                   const int64_t* line_offsets, int max_atom,
                   uint8_t* atom_mask, uint8_t* bond_mask, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  std::atomic<int64_t> next(0);
  std::vector<std::array<uint8_t, 256>> amasks(n_threads);
  std::vector<std::array<uint8_t, 64>> bmasks(n_threads);
  auto worker = [&](int t) {
    amasks[t].fill(0);
    bmasks[t].fill(0);
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_lines) break;
      int64_t off = line_offsets[i];
      int64_t end = (i + 1 < n_lines) ? line_offsets[i + 1] : buf_len;
      std::string s(buf + off, buf + end);
      size_t start = s.find_first_not_of(" \t\r\n");
      if (start == std::string::npos) continue;
      size_t stop = s.find_first_of(" \t\r\n", start);
      s = s.substr(start, stop == std::string::npos ? stop : stop - start);
      if (s.empty()) continue;
      Parser p(s);
      if (!p.run()) continue;
      Mol& m = p.mol;
      if (!sanitize(m).ok) continue;
      if ((int)m.atoms.size() > max_atom) continue;
      for (const auto& a : m.atoms)
        if (a.z >= 0 && a.z < 256) amasks[t][a.z] = 1;
      for (const auto& b : m.bonds)
        if (b.type >= 0 && b.type < 64) bmasks[t][b.type] = 1;
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
  for (int t = 0; t < n_threads; ++t) {
    for (int k = 0; k < 256; ++k) atom_mask[k] |= amasks[t][k];
    for (int k = 0; k < 64; ++k) bond_mask[k] |= bmasks[t][k];
  }
}

int dg_abi_version() { return 1; }
}
