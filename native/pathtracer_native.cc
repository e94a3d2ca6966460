// Native helpers for the path tracer (the analog of the reference's
// native C++ components: the fpng PNG encoder and the in-header C++ SAH BVH
// builder, /root/reference/pathtracer/fpng.cc and bvh.h:48-155).
//
// Exposed as a C ABI consumed via ctypes (pathtracer_tpu/utils/native.py).
// Build: make -C native   ->  libpathtracer_native.so
//
// Components:
//   pt_write_png  — PNG encoder (zlib deflate, filter 0). I/O path parity
//                   with the reference's fpng usage (image.h:45-62).
//   pt_build_bvh  — surface-area-heuristic BVH build over triangle AABBs /
//                   centroids, emitting the same flat node arrays as the
//                   Python builder (pathtracer_tpu/bvh.py): full-sweep SAH
//                   via per-axis sorted prefix scans (O(n log n) per node),
//                   identical split candidates and cost function to
//                   bvh.h:48-78 (cost = l_cnt*l_area + r_cnt*r_area, area =
//                   HALF box surface, compared against tri_count*node_area).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// PNG writer
// ---------------------------------------------------------------------------

static void put_be32(std::vector<uint8_t>& out, uint32_t v) {
    out.push_back(v >> 24);
    out.push_back(v >> 16);
    out.push_back(v >> 8);
    out.push_back(v);
}

static void put_chunk(std::vector<uint8_t>& out, const char tag[4],
                      const uint8_t* data, size_t len) {
    put_be32(out, (uint32_t)len);
    size_t start = out.size();
    out.insert(out.end(), tag, tag + 4);
    out.insert(out.end(), data, data + len);
    uLong crc = crc32(0L, out.data() + start, (uInt)(len + 4));
    put_be32(out, (uint32_t)crc);
}

// rgb: h*w*3 bytes, row 0 first. Returns 1 on success.
int pt_write_png(const char* filename, const uint8_t* rgb, int w, int h) {
    const size_t stride = (size_t)w * 3;
    std::vector<uint8_t> raw((stride + 1) * h);
    for (int y = 0; y < h; y++) {
        raw[y * (stride + 1)] = 0;  // filter 0
        std::memcpy(&raw[y * (stride + 1) + 1], rgb + y * stride, stride);
    }

    uLongf zcap = compressBound((uLong)raw.size());
    std::vector<uint8_t> z(zcap);
    if (compress2(z.data(), &zcap, raw.data(), (uLong)raw.size(), 6) != Z_OK)
        return 0;

    std::vector<uint8_t> out;
    static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    out.insert(out.end(), sig, sig + 8);

    uint8_t ihdr[13];
    ihdr[0] = w >> 24; ihdr[1] = w >> 16; ihdr[2] = w >> 8; ihdr[3] = w;
    ihdr[4] = h >> 24; ihdr[5] = h >> 16; ihdr[6] = h >> 8; ihdr[7] = h;
    ihdr[8] = 8;   // bit depth
    ihdr[9] = 2;   // RGB
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    put_chunk(out, "IHDR", ihdr, 13);
    put_chunk(out, "IDAT", z.data(), zcap);
    put_chunk(out, "IEND", nullptr, 0);

    FILE* f = std::fopen(filename, "wb");
    if (!f) return 0;
    size_t n = std::fwrite(out.data(), 1, out.size(), f);
    std::fclose(f);
    return n == out.size();
}

// ---------------------------------------------------------------------------
// SAH BVH builder
// ---------------------------------------------------------------------------

struct Box {
    float lb[3], rt[3];
    void reset() {
        for (int c = 0; c < 3; c++) {
            lb[c] = std::numeric_limits<float>::infinity();
            rt[c] = -std::numeric_limits<float>::infinity();
        }
    }
    void merge(const float* tlb, const float* trt) {
        for (int c = 0; c < 3; c++) {
            lb[c] = std::min(lb[c], tlb[c]);
            rt[c] = std::max(rt[c], trt[c]);
        }
    }
    // Half surface area; 0 for empty boxes (aabb.h:34-39 semantics).
    float half_area() const {
        if (lb[0] > rt[0] || lb[1] > rt[1] || lb[2] > rt[2]) return 0.f;
        float d0 = rt[0] - lb[0], d1 = rt[1] - lb[1], d2 = rt[2] - lb[2];
        return d0 * d1 + d0 * d2 + d1 * d2;
    }
};

// Returns node count (<= 2n), or 0 on failure. Output arrays are
// caller-allocated with capacity 2n (tri_idx: n).
int pt_build_bvh(int n, const float* tri_lb, const float* tri_rt,
                 const float* centroids, float* out_lb, float* out_rt,
                 int32_t* out_left, int32_t* out_right, int32_t* out_start,
                 int32_t* out_end, int32_t* out_tri_idx) {
    if (n <= 0) return 0;
    std::vector<int32_t> idx(n);
    std::iota(idx.begin(), idx.end(), 0);

    struct Node { Box box; int32_t l = -1, r = -1, s, e; };
    std::vector<Node> nodes;
    nodes.reserve(2 * n);
    nodes.push_back({Box{}, -1, -1, 0, n - 1});

    std::vector<int32_t> stack = {0};
    // scratch buffers reused across nodes
    std::vector<int32_t> order;
    std::vector<float> pre_area, suf_area;
    std::vector<int32_t> part;

    while (!stack.empty()) {
        int32_t ni = stack.back();
        stack.pop_back();
        int32_t s = nodes[ni].s, e = nodes[ni].e;
        int32_t m = e - s + 1;

        Box nb; nb.reset();
        for (int32_t i = s; i <= e; i++)
            nb.merge(&tri_lb[3 * idx[i]], &tri_rt[3 * idx[i]]);
        nodes[ni].box = nb;

        // Full-sweep SAH via sorted prefix/suffix scans on each axis.
        int best_axis = -1;
        float best_pos = 0.f, best_cost = std::numeric_limits<float>::infinity();
        if (m > 1) {
            order.resize(m);
            pre_area.resize(m);
            suf_area.resize(m);
            for (int axis = 0; axis < 3; axis++) {
                std::iota(order.begin(), order.end(), 0);
                std::stable_sort(order.begin(), order.end(),
                                 [&](int a, int b) {
                                     return centroids[3 * idx[s + a] + axis] <
                                            centroids[3 * idx[s + b] + axis];
                                 });
                Box acc; acc.reset();
                for (int k = 0; k < m; k++) {
                    int32_t t = idx[s + order[k]];
                    acc.merge(&tri_lb[3 * t], &tri_rt[3 * t]);
                    pre_area[k] = acc.half_area();
                }
                acc.reset();
                for (int k = m - 1; k >= 0; k--) {
                    int32_t t = idx[s + order[k]];
                    acc.merge(&tri_lb[3 * t], &tri_rt[3 * t]);
                    suf_area[k] = acc.half_area();
                }
                for (int k = 1; k < m; k++) {
                    float ck = centroids[3 * idx[s + order[k]] + axis];
                    float cp = centroids[3 * idx[s + order[k - 1]] + axis];
                    if (ck <= cp) continue;  // duplicate centroid value
                    float cost = k * pre_area[k - 1] + (m - k) * suf_area[k];
                    if (cost < best_cost) {
                        best_cost = cost;
                        best_axis = axis;
                        best_pos = ck;
                    }
                }
            }
        }

        float nosplit = m * nb.half_area();
        if (best_axis == -1 || best_cost > nosplit) continue;  // leaf

        // Stable partition: centroids < best_pos to the left.
        part.clear();
        part.reserve(m);
        int32_t left_cnt = 0;
        for (int32_t i = s; i <= e; i++)
            if (centroids[3 * idx[i] + best_axis] < best_pos)
                part.push_back(idx[i]), left_cnt++;
        for (int32_t i = s; i <= e; i++)
            if (!(centroids[3 * idx[i] + best_axis] < best_pos))
                part.push_back(idx[i]);
        if (left_cnt == 0 || left_cnt == m) continue;
        std::copy(part.begin(), part.end(), idx.begin() + s);

        int32_t li = (int32_t)nodes.size();
        nodes.push_back({Box{}, -1, -1, s, s + left_cnt - 1});
        int32_t ri = (int32_t)nodes.size();
        nodes.push_back({Box{}, -1, -1, s + left_cnt, e});
        nodes[ni].l = li;
        nodes[ni].r = ri;
        stack.push_back(li);
        stack.push_back(ri);
    }

    int32_t M = (int32_t)nodes.size();
    for (int32_t i = 0; i < M; i++) {
        std::memcpy(&out_lb[3 * i], nodes[i].box.lb, 12);
        std::memcpy(&out_rt[3 * i], nodes[i].box.rt, 12);
        out_left[i] = nodes[i].l;
        out_right[i] = nodes[i].r;
        out_start[i] = nodes[i].s;
        out_end[i] = nodes[i].e;
    }
    std::memcpy(out_tri_idx, idx.data(), sizeof(int32_t) * n);
    return M;
}

}  // extern "C"
