// Native acceleration-structure builders (SURVEY.md §2 rows R4/R5: the
// reference builds its BVH/grid on the C++ host; these are the new
// framework's equivalents, exposed through a C ABI consumed via ctypes —
// tpurt/accel/native.py — with the numpy builders as fallback).
//
// Build: see tpurt/native/Makefile (g++ -O3 -shared -fPIC).
//
// Both builders emit the SAME flattened cluster-block format the Pallas
// traversal kernel streams (tpurt/accel/clusters.py): (C, leaf) int32
// triangle ids padded with duplicates + per-cluster AABBs.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Clusters {
  std::vector<int32_t> tri_ids;  // C * leaf
  std::vector<float> lo;         // C * 3
  std::vector<float> hi;         // C * 3
  int64_t n = 0;
  int leaf = 128;
};

struct V3 {
  float x, y, z;
};

inline V3 vmin(V3 a, V3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(V3 a, V3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

void emit_leaf(Clusters* out, const int64_t* idx, int64_t count,
               const V3* tlo, const V3* thi) {
  V3 lo = tlo[idx[0]], hi = thi[idx[0]];
  for (int64_t i = 1; i < count; ++i) {
    lo = vmin(lo, tlo[idx[i]]);
    hi = vmax(hi, thi[idx[i]]);
  }
  for (int64_t i = 0; i < out->leaf; ++i) {
    out->tri_ids.push_back(
        static_cast<int32_t>(idx[i < count ? i : 0]));  // pad = duplicate
  }
  out->lo.insert(out->lo.end(), {lo.x, lo.y, lo.z});
  out->hi.insert(out->hi.end(), {hi.x, hi.y, hi.z});
  out->n += 1;
}

}  // namespace

extern "C" {

// Sweep-SAH cluster BVH: each node sweeps ALL THREE centroid-sorted axes
// and splits at the leaf-multiple boundary with the best surface-area-
// heuristic cost (leaves come out full; exactly one partial cluster
// globally).  SAH minimizes sum of child-box surface areas weighted by
// triangle count — for the flat traversal this directly minimizes the
// expected cull-survivor count per ray bundle, the kernel's measured cost
// driver (BASELINE.md survivor stats).  Measured vs median-split: total
// cluster area −8% on the 1M-tri config-5 mesh, −3% on config 4.
// 3 sorts per node, host-side one-time cost (~3 s at 1M tris).
namespace {
inline float half_area(V3 lo, V3 hi) {
  float dx = std::max(hi.x - lo.x, 0.f), dy = std::max(hi.y - lo.y, 0.f),
        dz = std::max(hi.z - lo.z, 0.f);
  return dx * dy + dy * dz + dz * dx;
}
}  // namespace

void* tpurt_build_clusters(const float* verts, int64_t /*V*/,
                           const int32_t* tris, int64_t T, int leaf,
                           int64_t* out_C) {
  auto* out = new Clusters();
  out->leaf = leaf;
  if (T == 0) {
    *out_C = 0;
    return out;
  }

  std::vector<V3> tlo(T), thi(T), cent(T);
  for (int64_t t = 0; t < T; ++t) {
    const float* a = verts + 3 * static_cast<int64_t>(tris[3 * t + 0]);
    const float* b = verts + 3 * static_cast<int64_t>(tris[3 * t + 1]);
    const float* c = verts + 3 * static_cast<int64_t>(tris[3 * t + 2]);
    V3 va{a[0], a[1], a[2]}, vb{b[0], b[1], b[2]}, vc{c[0], c[1], c[2]};
    tlo[t] = vmin(va, vmin(vb, vc));
    thi[t] = vmax(va, vmax(vb, vc));
    cent[t] = {(tlo[t].x + thi[t].x) * 0.5f, (tlo[t].y + thi[t].y) * 0.5f,
               (tlo[t].z + thi[t].z) * 0.5f};
  }

  std::vector<int64_t> idx(T);
  for (int64_t t = 0; t < T; ++t) idx[t] = t;
  // per-axis scratch (each axis sweep owns one so they can run in
  // parallel on big nodes)
  std::vector<float> rarea[3] = {std::vector<float>(T),
                                 std::vector<float>(T),
                                 std::vector<float>(T)};
  std::vector<int64_t> axbuf[3] = {std::vector<int64_t>(T),
                                   std::vector<int64_t>(T),
                                   std::vector<int64_t>(T)};

  std::vector<std::pair<int64_t, int64_t>> stack;  // [begin, end)
  stack.emplace_back(0, T);
  while (!stack.empty()) {
    auto [b, e] = stack.back();
    stack.pop_back();
    int64_t n = e - b;
    if (n <= leaf) {
      emit_leaf(out, idx.data() + b, n, tlo.data(), thi.data());
      continue;
    }
    // sweep every axis; keep the (axis, split) with the globally best SAH
    float best = 3.4e38f;
    int64_t best_k = std::max<int64_t>(
        leaf, ((n / 2 + leaf / 2) / leaf) * leaf);  // median fallback
    best_k = std::min<int64_t>(best_k, n - 1);
    // per-axis sweep: sort the candidate order, build suffix right-box
    // areas, then scan leaf-multiple split positions.  Left child keeps a
    // multiple of `leaf` triangles (full clusters); the remainder
    // accumulates to the globally-rightmost leaf.
    float ax_cost[3];
    int64_t ax_k[3];
    auto eval_axis = [&](int axis) {
      auto& buf = axbuf[axis];
      auto& ra = rarea[axis];
      std::copy(idx.begin() + b, idx.begin() + e, buf.begin());
      std::sort(buf.begin(), buf.begin() + n,
                [&](int64_t p, int64_t q) {
                  return (&cent[p].x)[axis] < (&cent[q].x)[axis];
                });
      V3 rlo = tlo[buf[n - 1]], rhi = thi[buf[n - 1]];
      for (int64_t i = n - 1; i >= 1; --i) {
        rlo = vmin(rlo, tlo[buf[i]]);
        rhi = vmax(rhi, thi[buf[i]]);
        ra[i] = half_area(rlo, rhi);
      }
      V3 llo = tlo[buf[0]], lhi = thi[buf[0]];
      float bc = 3.4e38f;
      int64_t bk = -1;
      for (int64_t i = 0; i < n - 1; ++i) {
        llo = vmin(llo, tlo[buf[i]]);
        lhi = vmax(lhi, thi[buf[i]]);
        int64_t k = i + 1;
        if (k % leaf != 0) continue;
        float cost = half_area(llo, lhi) * float(k) + ra[k] * float(n - k);
        if (cost < bc) {
          bc = cost;
          bk = k;
        }
      }
      ax_cost[axis] = bc;
      ax_k[axis] = bk;
    };
    if (n > (int64_t)32 * 1024) {
      // the top-level sorts dominate build time — run the three axis
      // sweeps concurrently (each owns its scratch)
      std::thread t1(eval_axis, 1), t2(eval_axis, 2);
      eval_axis(0);
      t1.join();
      t2.join();
    } else {
      for (int axis = 0; axis < 3; ++axis) eval_axis(axis);
    }
    int bax = -1;
    for (int axis = 0; axis < 3; ++axis) {
      if (ax_k[axis] >= 0 && ax_cost[axis] < best) {
        best = ax_cost[axis];
        bax = axis;
      }
    }
    if (bax >= 0) {
      best_k = ax_k[bax];
      std::copy(axbuf[bax].begin(), axbuf[bax].begin() + n, idx.begin() + b);
    }
    int64_t mid = b + best_k;
    stack.emplace_back(b, mid);
    stack.emplace_back(mid, e);
  }
  *out_C = out->n;
  return out;
}

// Uniform grid: triangles rasterized into cells by AABB overlap; each
// occupied cell spills into >=1 cluster blocks whose AABB is the (tight)
// cell∩content box.  Returns the same Clusters format.
void* tpurt_build_grid(const float* verts, int64_t /*V*/, const int32_t* tris,
                       int64_t T, int target_per_cell, int leaf,
                       int64_t* out_C) {
  auto* out = new Clusters();
  out->leaf = leaf;
  if (T == 0) {
    *out_C = 0;
    return out;
  }

  std::vector<V3> tlo(T), thi(T);
  V3 slo{3e38f, 3e38f, 3e38f}, shi{-3e38f, -3e38f, -3e38f};
  for (int64_t t = 0; t < T; ++t) {
    const float* a = verts + 3 * static_cast<int64_t>(tris[3 * t + 0]);
    const float* b = verts + 3 * static_cast<int64_t>(tris[3 * t + 1]);
    const float* c = verts + 3 * static_cast<int64_t>(tris[3 * t + 2]);
    V3 va{a[0], a[1], a[2]}, vb{b[0], b[1], b[2]}, vc{c[0], c[1], c[2]};
    tlo[t] = vmin(va, vmin(vb, vc));
    thi[t] = vmax(va, vmax(vb, vc));
    slo = vmin(slo, tlo[t]);
    shi = vmax(shi, thi[t]);
  }
  float ext[3] = {std::max(shi.x - slo.x, 1e-6f),
                  std::max(shi.y - slo.y, 1e-6f),
                  std::max(shi.z - slo.z, 1e-6f)};
  double n_cells = std::max<double>(1.0, double(T) / target_per_cell);
  double vol = double(ext[0]) * ext[1] * ext[2];
  double k = std::cbrt(n_cells / vol);
  int64_t dims[3];
  for (int a = 0; a < 3; ++a) {
    dims[a] = std::max<int64_t>(
        1, std::min<int64_t>(256, (int64_t)std::ceil(ext[a] * k)));
  }
  float cell[3] = {ext[0] / dims[0], ext[1] / dims[1], ext[2] / dims[2]};
  const float* slo_p = &slo.x;

  auto cell_of = [&](const float* p, int64_t* c) {
    for (int a = 0; a < 3; ++a) {
      int64_t v = (int64_t)((p[a] - slo_p[a]) / cell[a]);
      c[a] = std::max<int64_t>(0, std::min(dims[a] - 1, v));
    }
  };

  std::unordered_map<int64_t, std::vector<int64_t>> cells;
  for (int64_t t = 0; t < T; ++t) {
    int64_t c0[3], c1[3];
    cell_of(&tlo[t].x, c0);
    cell_of(&thi[t].x, c1);
    for (int64_t x = c0[0]; x <= c1[0]; ++x)
      for (int64_t y = c0[1]; y <= c1[1]; ++y)
        for (int64_t z = c0[2]; z <= c1[2]; ++z)
          cells[(x * dims[1] + y) * dims[2] + z].push_back(t);
  }

  for (auto& [key, ids] : cells) {
    int64_t z = key % dims[2], y = (key / dims[2]) % dims[1],
            x = key / (dims[1] * dims[2]);
    V3 clo{slo.x + x * cell[0], slo.y + y * cell[1], slo.z + z * cell[2]};
    V3 chi{clo.x + cell[0], clo.y + cell[1], clo.z + cell[2]};
    for (size_t s = 0; s < ids.size(); s += leaf) {
      int64_t cnt = std::min<int64_t>(leaf, ids.size() - s);
      // tight bounds: content ∩ cell
      V3 blo = tlo[ids[s]], bhi = thi[ids[s]];
      for (int64_t i = 1; i < cnt; ++i) {
        blo = vmin(blo, tlo[ids[s + i]]);
        bhi = vmax(bhi, thi[ids[s + i]]);
      }
      blo = vmax(blo, clo);
      bhi = vmin(bhi, chi);
      for (int64_t i = 0; i < leaf; ++i) {
        out->tri_ids.push_back(
            static_cast<int32_t>(ids[s + (i < cnt ? i : 0)]));
      }
      out->lo.insert(out->lo.end(), {blo.x, blo.y, blo.z});
      out->hi.insert(out->hi.end(), {bhi.x, bhi.y, bhi.z});
      out->n += 1;
    }
  }
  *out_C = out->n;
  return out;
}

void tpurt_get_clusters(void* handle, int32_t* tri_ids, float* lo, float* hi) {
  auto* c = static_cast<Clusters*>(handle);
  std::memcpy(tri_ids, c->tri_ids.data(), c->tri_ids.size() * sizeof(int32_t));
  std::memcpy(lo, c->lo.data(), c->lo.size() * sizeof(float));
  std::memcpy(hi, c->hi.data(), c->hi.size() * sizeof(float));
}

void tpurt_free_clusters(void* handle) {
  delete static_cast<Clusters*>(handle);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Wavefront .obj loader (SURVEY.md §2 row R11 — the reference's scene loader
// is C++; this is the native fast path behind tpurt/scene/obj.py, which
// keeps the numpy implementation as the semantic spec and fallback).
// Output is BIT-IDENTICAL to the python loader: same tokenization, final-
// count negative-index resolution, fan triangulation, usemtl grouping, and
// np.unique-compatible (lexicographically sorted) seam-preserving corner
// dedup.  ~20× the python parse at 1M triangles.
// ---------------------------------------------------------------------------

#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <string>

namespace {

struct ObjData {
  std::vector<float> verts;      // V' * 3
  std::vector<int32_t> tris;     // T * 3
  std::vector<float> uvs;        // V' * 2
  std::vector<float> normals;    // V' * 3 (empty when the file has none)
  std::vector<int32_t> tri_group;
  std::vector<std::string> groups;
};

struct Corner {
  int64_t v, t, n;
  bool operator<(const Corner& o) const {
    if (v != o.v) return v < o.v;
    if (t != o.t) return t < o.t;
    return n < o.n;
  }
  bool operator==(const Corner& o) const {
    return v == o.v && t == o.t && n == o.n;
  }
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_ws(const char* p, const char* end) {
  while (p < end && *p != ' ' && *p != '\t' && *p != '\r') ++p;
  return p;
}

// Locale-independent float parse (python float() is locale-independent;
// std::strtod honors LC_NUMERIC and would silently misparse "0.25" under a
// comma-decimal locale, breaking the bit-identical contract).  Accepts an
// optional leading '+' (python does; std::from_chars does not).
inline const char* parse_float(const char* p, const char* end, float* out) {
  if (p < end && *p == '+') ++p;
  auto res = std::from_chars(p, end, *out);
  if (res.ec != std::errc()) *out = 0.0f;
  return res.ptr;
}

inline const char* parse_int(const char* p, const char* end, int64_t* out) {
  if (p < end && *p == '+') ++p;
  auto res = std::from_chars(p, end, *out);
  if (res.ec != std::errc()) *out = 0;
  return res.ptr;
}

}  // namespace

extern "C" {

void* tpurt_load_obj(const char* path, int64_t* out_nv, int64_t* out_nt,
                     int* out_has_normals, int64_t* out_ngroups) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {  // ftell failure: -1 would make buf(0) and buf[size] UB
    std::fclose(f);
    return nullptr;
  }
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (size > 0 && std::fread(buf.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  buf[size] = '\n';

  std::vector<float> vs, vts, vns;      // raw file arrays (3/2/3-wide)
  struct Face { Corner c[3]; int32_t g; };
  std::vector<Face> faces;
  std::vector<std::string> groups{"default"};
  int32_t cur_group = 0;
  std::vector<Corner> poly;             // scratch for fan triangulation

  const char* p = buf.data();
  const char* end = buf.data() + size + 1;
  while (p < end) {
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) eol = end;
    const char* q = skip_ws(p, eol);
    p = eol + 1;
    if (q >= eol || *q == '#') continue;
    const char* tag_end = next_ws(q, eol);
    size_t tlen = tag_end - q;
    auto read_floats = [&](std::vector<float>* out, int want, float fill) {
      const char* r = tag_end;
      for (int k = 0; k < want; ++k) {
        r = skip_ws(r, eol);
        if (r >= eol) {
          out->push_back(fill);
        } else {
          float v = fill;
          r = parse_float(r, eol, &v);
          out->push_back(v);
        }
      }
    };
    if (tlen == 1 && q[0] == 'v') {
      read_floats(&vs, 3, 0.0f);
    } else if (tlen == 2 && q[0] == 'v' && q[1] == 't') {
      read_floats(&vts, 2, 0.0f);       // python: vt with 1 coord -> (u, 0)
    } else if (tlen == 2 && q[0] == 'v' && q[1] == 'n') {
      read_floats(&vns, 3, 0.0f);
    } else if (tlen == 6 && std::memcmp(q, "usemtl", 6) == 0) {
      const char* r = skip_ws(tag_end, eol);
      std::string name = r < eol ? std::string(r, next_ws(r, eol) - r)
                                 : std::string("default");
      if (name.empty()) name = "default";
      int32_t gi = -1;
      for (size_t i = 0; i < groups.size(); ++i)
        if (groups[i] == name) { gi = (int32_t)i; break; }
      if (gi < 0) { gi = (int32_t)groups.size(); groups.push_back(name); }
      cur_group = gi;
    } else if (tlen == 1 && q[0] == 'f') {
      poly.clear();
      const char* r = tag_end;
      while (true) {
        r = skip_ws(r, eol);
        if (r >= eol) break;
        // Bound every numeric parse to THIS token: a trailing slash
        // ("f 1/ 2/ 3/") must yield ti=0 like the python spec parser,
        // not consume the next corner's vertex index.
        const char* tok_end = next_ws(r, eol);
        int64_t vi = 0, ti = 0, ni = 0;
        r = parse_int(r, tok_end, &vi);
        if (r < tok_end && *r == '/') {
          ++r;
          if (r < tok_end && *r != '/') r = parse_int(r, tok_end, &ti);
          if (r < tok_end && *r == '/') { ++r; parse_int(r, tok_end, &ni); }
        }
        poly.push_back({vi, ti, ni});
        r = tok_end;
      }
      for (size_t k = 1; k + 1 < poly.size(); ++k)
        faces.push_back({{poly[0], poly[k], poly[k + 1]}, cur_group});
    }
  }

  const int64_t V = (int64_t)vs.size() / 3;
  const int64_t NT = (int64_t)vts.size() / 2;
  const int64_t NN = (int64_t)vns.size() / 3;
  const int64_t F = (int64_t)faces.size();
  auto resolve = [](int64_t i, int64_t n) { return i > 0 ? i - 1 : n + i; };

  // one row per corner, resolved exactly like the python loader (FINAL
  // counts for negative indices; 0 uv/normal index -> -1 sentinel)
  std::vector<Corner> corner(F * 3);
  for (int64_t t = 0; t < F; ++t)
    for (int k = 0; k < 3; ++k) {
      const Corner& c = faces[t].c[k];
      corner[t * 3 + k] = {resolve(c.v, V), c.t ? resolve(c.t, NT) : -1,
                           c.n ? resolve(c.n, NN) : -1};
    }
  // np.unique(axis=0): unique rows in LEXICOGRAPHIC order + inverse map
  std::vector<int64_t> order(F * 3);
  for (int64_t i = 0; i < F * 3; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (!(corner[a] == corner[b])) return corner[a] < corner[b];
    return a < b;
  });
  auto* out = new ObjData();
  std::vector<int32_t> inverse(F * 3);
  std::vector<Corner> uniq;
  uniq.reserve(F * 3);
  for (int64_t i = 0; i < F * 3; ++i) {
    if (i == 0 || !(corner[order[i]] == corner[order[i - 1]]))
      uniq.push_back(corner[order[i]]);
    inverse[order[i]] = (int32_t)(uniq.size() - 1);
  }
  const int64_t Vp = (int64_t)uniq.size();
  out->tris.assign(inverse.begin(), inverse.end());
  out->tri_group.reserve(F);
  for (auto& fc : faces) out->tri_group.push_back(fc.g);

  out->verts.resize(Vp * 3);
  out->uvs.assign(Vp * 2, 0.0f);
  bool any_n = false;
  for (auto& u : uniq) any_n |= (u.n >= 0);
  const bool has_normals = NN > 0 && any_n;
  if (has_normals) out->normals.assign(Vp * 3, 0.0f);
  for (int64_t i = 0; i < Vp; ++i) {
    const Corner& u = uniq[i];
    out->verts[i * 3 + 0] = vs[u.v * 3 + 0];
    out->verts[i * 3 + 1] = vs[u.v * 3 + 1];
    out->verts[i * 3 + 2] = vs[u.v * 3 + 2];
    if (u.t >= 0) {
      out->uvs[i * 2 + 0] = vts[u.t * 2 + 0];
      out->uvs[i * 2 + 1] = vts[u.t * 2 + 1];
    }
    if (has_normals && u.n >= 0) {
      // normalize in f32 with the python loader's exact op order:
      // sqrt((x*x + y*y) + z*z), divide by max(len, 1e-20)
      float x = vns[u.n * 3 + 0], y = vns[u.n * 3 + 1], z = vns[u.n * 3 + 2];
      float len = std::sqrt((x * x + y * y) + z * z);
      float d = std::max(len, 1e-20f);
      out->normals[i * 3 + 0] = x / d;
      out->normals[i * 3 + 1] = y / d;
      out->normals[i * 3 + 2] = z / d;
    }
  }
  out->groups = std::move(groups);
  *out_nv = Vp;
  *out_nt = F;
  *out_has_normals = has_normals ? 1 : 0;
  *out_ngroups = (int64_t)out->groups.size();
  return out;
}

void tpurt_get_obj(void* handle, float* verts, int32_t* tris, float* uvs,
                   float* normals, int32_t* tri_group) {
  auto* o = static_cast<ObjData*>(handle);
  std::memcpy(verts, o->verts.data(), o->verts.size() * sizeof(float));
  std::memcpy(tris, o->tris.data(), o->tris.size() * sizeof(int32_t));
  std::memcpy(uvs, o->uvs.data(), o->uvs.size() * sizeof(float));
  if (normals && !o->normals.empty())
    std::memcpy(normals, o->normals.data(), o->normals.size() * sizeof(float));
  std::memcpy(tri_group, o->tri_group.data(),
              o->tri_group.size() * sizeof(int32_t));
}

const char* tpurt_obj_group_name(void* handle, int64_t i) {
  auto* o = static_cast<ObjData*>(handle);
  if (i < 0 || i >= (int64_t)o->groups.size()) return "";
  return o->groups[i].c_str();
}

void tpurt_free_obj(void* handle) { delete static_cast<ObjData*>(handle); }

}  // extern "C"
