// ipc_native: host-side C++ runtime functions for ipc_tpu_torch.
//
// The port's own copy of ipc_tpu/native/ipc_native.cpp (the port imports
// nothing of ipc_tpu), the same code. It provides host-side pieces that
// stay off the device:
//
//   * Gmsh 4.1 / legacy 2.2 ASCII .msh parsing (role of the reference's
//     MshIO dependency + IglUtils::readTetMesh, src/Utils/IglUtils.cpp),
//   * boundary-face extraction / surface-edge dedup (role of
//     Mesh::computeFeatures, src/Mesh.cpp:415-560),
//   * a uniform-grid spatial hash producing point-triangle / edge-edge
//     candidate pairs (role of SpatialHash<3>, src/Utils/SpatialHash.hpp),
//     a host-side broad phase.
//
// Exposed as a C ABI consumed via ctypes (ipc_tpu_torch/native/__init__.py).
// Buffers returned to Python are malloc'd here and released with
// ipc_free(); all index types are int32, coordinates double.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <unordered_map>
#include <vector>
#include <algorithm>

extern "C" {

void ipc_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// .msh parsing
// ---------------------------------------------------------------------------

// Returns 0 on success. Outputs: V (nV x 3 doubles), T (nT x 4 int32).
int parse_msh(const char* path, double** V_out, int64_t* nV_out,
              int32_t** T_out, int64_t* nT_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::string buf(size, '\0');
    if (std::fread(&buf[0], 1, size, f) != (size_t)size) {
        std::fclose(f);
        return 2;
    }
    std::fclose(f);

    // tokenize line by line
    std::vector<std::string> lines;
    {
        size_t start = 0;
        for (size_t i = 0; i <= buf.size(); ++i) {
            if (i == buf.size() || buf[i] == '\n') {
                lines.emplace_back(buf.substr(start, i - start));
                start = i + 1;
            }
        }
    }

    auto find_section = [&](const char* name, size_t from) -> size_t {
        for (size_t i = from; i < lines.size(); ++i)
            if (lines[i].rfind(name, 0) == 0) return i;
        return lines.size();
    };

    size_t fmt = find_section("$MeshFormat", 0);
    if (fmt + 1 >= lines.size()) return 3;
    double version = std::atof(lines[fmt + 1].c_str());

    std::vector<double> V;
    std::vector<int32_t> T;
    std::unordered_map<int64_t, int32_t> tag2idx;

    if (version >= 4.0) {
        size_t ns = find_section("$Nodes", fmt);
        if (ns + 1 >= lines.size()) return 4;
        long nblocks, nnodes;
        std::sscanf(lines[ns + 1].c_str(), "%ld %ld", &nblocks, &nnodes);
        V.reserve(nnodes * 3);
        size_t i = ns + 2;
        int32_t count = 0;
        for (long b = 0; b < nblocks; ++b) {
            long dim, tag, par, n;
            std::sscanf(lines[i++].c_str(), "%ld %ld %ld %ld", &dim, &tag, &par, &n);
            std::vector<int64_t> tags(n);
            for (long k = 0; k < n; ++k) tags[k] = std::atoll(lines[i++].c_str());
            for (long k = 0; k < n; ++k) {
                double x, y, z;
                std::sscanf(lines[i++].c_str(), "%lf %lf %lf", &x, &y, &z);
                V.push_back(x);
                V.push_back(y);
                V.push_back(z);
                tag2idx[tags[k]] = count++;
            }
        }
        size_t es = find_section("$Elements", i);
        if (es + 1 >= lines.size()) return 5;
        long eblocks, nelems;
        std::sscanf(lines[es + 1].c_str(), "%ld %ld", &eblocks, &nelems);
        i = es + 2;
        for (long b = 0; b < eblocks; ++b) {
            long dim, tag, etype, n;
            std::sscanf(lines[i++].c_str(), "%ld %ld %ld %ld", &dim, &tag, &etype, &n);
            for (long k = 0; k < n; ++k) {
                if (etype == 4) {
                    long id, a, bb, c, d;
                    std::sscanf(lines[i].c_str(), "%ld %ld %ld %ld %ld", &id, &a, &bb, &c, &d);
                    T.push_back(tag2idx[a]);
                    T.push_back(tag2idx[bb]);
                    T.push_back(tag2idx[c]);
                    T.push_back(tag2idx[d]);
                }
                ++i;
            }
        }
    } else {
        // legacy 2.2
        size_t ns = find_section("$Nodes", 0);
        long n = std::atol(lines[ns + 1].c_str());
        size_t i = ns + 2;
        int32_t count = 0;
        for (long k = 0; k < n; ++k) {
            long tag;
            double x, y, z;
            std::sscanf(lines[i++].c_str(), "%ld %lf %lf %lf", &tag, &x, &y, &z);
            V.push_back(x);
            V.push_back(y);
            V.push_back(z);
            tag2idx[tag] = count++;
        }
        size_t es = find_section("$Elements", i);
        long ne = std::atol(lines[es + 1].c_str());
        i = es + 2;
        for (long k = 0; k < ne; ++k) {
            long id, etype, ntags;
            int consumed = 0;
            std::sscanf(lines[i].c_str(), "%ld %ld %ld%n", &id, &etype, &ntags, &consumed);
            if (etype == 4) {
                const char* s = lines[i].c_str() + consumed;
                long vals[16];
                int got = 0;
                char* end;
                while (got < ntags + 4) {
                    vals[got++] = std::strtol(s, &end, 10);
                    s = end;
                }
                for (int j = 0; j < 4; ++j) T.push_back(tag2idx[vals[ntags + j]]);
            }
            ++i;
        }
    }

    *nV_out = (int64_t)(V.size() / 3);
    *nT_out = (int64_t)(T.size() / 4);
    *V_out = (double*)std::malloc(V.size() * sizeof(double));
    *T_out = (int32_t*)std::malloc(T.size() * sizeof(int32_t));
    std::memcpy(*V_out, V.data(), V.size() * sizeof(double));
    std::memcpy(*T_out, T.data(), T.size() * sizeof(int32_t));
    return 0;
}

// ---------------------------------------------------------------------------
// boundary faces (outward oriented, assumes positively-oriented tets)
// ---------------------------------------------------------------------------

int boundary_faces(const int32_t* tets, int64_t nT, int32_t** faces_out,
                   int64_t* nF_out) {
    static const int F[4][3] = {{0, 2, 1}, {0, 1, 3}, {1, 2, 3}, {0, 3, 2}};
    struct Key {
        int32_t a, b, c;
        bool operator==(const Key& o) const { return a == o.a && b == o.b && c == o.c; }
    };
    struct KeyHash {
        size_t operator()(const Key& k) const {
            size_t h = (size_t)k.a * 73856093u ^ (size_t)k.b * 19349663u ^
                       (size_t)k.c * 83492791u;
            return h;
        }
    };
    std::unordered_map<Key, std::pair<int32_t, int32_t>, KeyHash> count;  // -> (count, first face idx)
    std::vector<int32_t> all;
    all.reserve(nT * 12);
    for (int64_t t = 0; t < nT; ++t) {
        for (int fi = 0; fi < 4; ++fi) {
            int32_t v[3] = {tets[t * 4 + F[fi][0]], tets[t * 4 + F[fi][1]],
                            tets[t * 4 + F[fi][2]]};
            all.push_back(v[0]);
            all.push_back(v[1]);
            all.push_back(v[2]);
            int32_t s[3] = {v[0], v[1], v[2]};
            std::sort(s, s + 3);
            Key k{s[0], s[1], s[2]};
            auto it = count.find(k);
            if (it == count.end())
                count.emplace(k, std::make_pair(1, (int32_t)(all.size() / 3 - 1)));
            else
                it->second.first++;
        }
    }
    std::vector<int32_t> out;
    for (auto& kv : count) {
        if (kv.second.first == 1) {
            int32_t fi = kv.second.second;
            out.push_back(all[fi * 3]);
            out.push_back(all[fi * 3 + 1]);
            out.push_back(all[fi * 3 + 2]);
        }
    }
    *nF_out = (int64_t)(out.size() / 3);
    *faces_out = (int32_t*)std::malloc(out.size() * sizeof(int32_t));
    std::memcpy(*faces_out, out.data(), out.size() * sizeof(int32_t));
    return 0;
}

// ---------------------------------------------------------------------------
// uniform-grid spatial hash broad phase (SpatialHash<3> role)
// ---------------------------------------------------------------------------

namespace {

struct Grid {
    double lo[3];
    double cell;
    int64_t dims[3];
    // cell id -> list of primitive ids
    std::unordered_map<int64_t, std::vector<int32_t>> cells;

    int64_t cell_id(int64_t ix, int64_t iy, int64_t iz) const {
        return (ix * dims[1] + iy) * dims[2] + iz;
    }
    void locate(const double* bmin, const double* bmax, int64_t* i0, int64_t* i1) const {
        for (int d = 0; d < 3; ++d) {
            i0[d] = std::max<int64_t>(0, (int64_t)((bmin[d] - lo[d]) / cell));
            i1[d] = std::min<int64_t>(dims[d] - 1, (int64_t)((bmax[d] - lo[d]) / cell));
        }
    }
    void insert(int32_t id, const double* bmin, const double* bmax) {
        int64_t i0[3], i1[3];
        locate(bmin, bmax, i0, i1);
        for (int64_t x = i0[0]; x <= i1[0]; ++x)
            for (int64_t y = i0[1]; y <= i1[1]; ++y)
                for (int64_t z = i0[2]; z <= i1[2]; ++z)
                    cells[cell_id(x, y, z)].push_back(id);
    }
};

void prim_aabb(const double* X, const int32_t* idx, int k, double gap,
               double* bmin, double* bmax) {
    for (int d = 0; d < 3; ++d) {
        bmin[d] = 1e300;
        bmax[d] = -1e300;
    }
    for (int j = 0; j < k; ++j) {
        const double* p = X + (int64_t)idx[j] * 3;
        for (int d = 0; d < 3; ++d) {
            bmin[d] = std::min(bmin[d], p[d]);
            bmax[d] = std::max(bmax[d], p[d]);
        }
    }
    for (int d = 0; d < 3; ++d) {
        bmin[d] -= gap;
        bmax[d] += gap;
    }
}

bool aabb_overlap(const double* amin, const double* amax, const double* bmin,
                  const double* bmax) {
    for (int d = 0; d < 3; ++d)
        if (amin[d] > bmax[d] || bmin[d] > amax[d]) return false;
    return true;
}

}  // namespace

// Candidate (a, b) pairs between primitive set A (ka verts each) and B (kb
// verts each) whose gap-inflated AABBs overlap. skip_shared excludes pairs
// sharing a vertex id; upper_only emits only a<b (for A==B edge-edge).
// Returns the number of pairs written (<= cap); *total_out is the true count.
int64_t grid_candidates(const double* X, int64_t /*nX*/,
                        const int32_t* A, int64_t nA, int32_t ka,
                        const int32_t* B, int64_t nB, int32_t kb,
                        double cell_size, double gap,
                        int32_t skip_shared, int32_t upper_only,
                        int32_t* pairs_out, int64_t cap, int64_t* total_out) {
    Grid g;
    g.cell = cell_size;
    // grid bounds from set B
    double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
    std::vector<double> bmin(nB * 3), bmax(nB * 3);
    for (int64_t b = 0; b < nB; ++b) {
        prim_aabb(X, B + b * kb, kb, gap, &bmin[b * 3], &bmax[b * 3]);
        for (int d = 0; d < 3; ++d) {
            lo[d] = std::min(lo[d], bmin[b * 3 + d]);
            hi[d] = std::max(hi[d], bmax[b * 3 + d]);
        }
    }
    for (int d = 0; d < 3; ++d) {
        g.lo[d] = lo[d];
        g.dims[d] = std::max<int64_t>(1, (int64_t)((hi[d] - lo[d]) / cell_size) + 1);
        g.dims[d] = std::min<int64_t>(g.dims[d], 1024);
    }
    for (int64_t b = 0; b < nB; ++b) g.insert((int32_t)b, &bmin[b * 3], &bmax[b * 3]);

    int64_t total = 0, written = 0;
    std::vector<char> seen(nB, 0);
    std::vector<int32_t> touched;
    for (int64_t a = 0; a < nA; ++a) {
        double amin[3], amax[3];
        prim_aabb(X, A + a * ka, ka, gap, amin, amax);
        int64_t i0[3], i1[3];
        g.locate(amin, amax, i0, i1);
        touched.clear();
        for (int64_t x = i0[0]; x <= i1[0]; ++x)
            for (int64_t y = i0[1]; y <= i1[1]; ++y)
                for (int64_t z = i0[2]; z <= i1[2]; ++z) {
                    auto it = g.cells.find(g.cell_id(x, y, z));
                    if (it == g.cells.end()) continue;
                    for (int32_t b : it->second) {
                        if (seen[b]) continue;
                        seen[b] = 1;
                        touched.push_back(b);
                        if (upper_only && b <= a) continue;
                        if (skip_shared) {
                            bool shared = false;
                            for (int i = 0; i < ka && !shared; ++i)
                                for (int j = 0; j < kb; ++j)
                                    if (A[a * ka + i] == B[(int64_t)b * kb + j]) {
                                        shared = true;
                                        break;
                                    }
                            if (shared) continue;
                        }
                        if (!aabb_overlap(amin, amax, &bmin[(int64_t)b * 3],
                                          &bmax[(int64_t)b * 3]))
                            continue;
                        if (written < cap) {
                            pairs_out[written * 2] = (int32_t)a;
                            pairs_out[written * 2 + 1] = b;
                            ++written;
                        }
                        ++total;
                    }
                }
        for (int32_t b : touched) seen[b] = 0;
    }
    *total_out = total;
    return written;
}

}  // extern "C"
