// Host-side native point-cloud ops + dataset codec for the data pipeline.
//
// These are this stack's counterparts of the reference's native op sets
// (GenORM/policy/tf_ops/sampling/tf_sampling_g.cu farthest-point sampling,
// grouping/tf_grouping_g.cu ball query, 3d_interpolation/interpolate.cpp
// three-NN) re-implemented as a plain C ABI shared library: the on-device
// path is plain JAX/XLA (unidom_tpu/models/pointnet_ops.py); this library
// serves the host data loader (subsampling expert clouds, packing record
// files) where Python-loop implementations are the bottleneck.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libpointops.so pointops.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cfloat>
#include <cmath>

extern "C" {

// Farthest-point sampling, first sample = index 0.
// xyz: (n, 3) float32, out_idx: (m,) int32.
void fps(const float* xyz, int n, int m, int32_t* out_idx) {
    if (n <= 0 || m <= 0) return;
    float* min_d2 = new float[n];
    for (int i = 0; i < n; ++i) min_d2[i] = FLT_MAX;
    int last = 0;
    out_idx[0] = 0;
    for (int s = 1; s < m; ++s) {
        const float lx = xyz[3 * last], ly = xyz[3 * last + 1], lz = xyz[3 * last + 2];
        float best = -1.0f;
        int best_i = 0;
        for (int i = 0; i < n; ++i) {
            const float dx = xyz[3 * i] - lx;
            const float dy = xyz[3 * i + 1] - ly;
            const float dz = xyz[3 * i + 2] - lz;
            const float d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < min_d2[i]) min_d2[i] = d2;
            if (min_d2[i] > best) { best = min_d2[i]; best_i = i; }
        }
        out_idx[s] = best_i;
        last = best_i;
    }
    delete[] min_d2;
}

// Ball query: first k in-radius points in index order, padded with the
// first hit (tf_grouping_g.cu:3-40 semantics). Centers with no hits get 0.
// xyz: (n, 3), centers: (s, 3), out_idx: (s, k) int32.
void ball_query(const float* xyz, int n, const float* centers, int s,
                float radius, int k, int32_t* out_idx) {
    const float r2 = radius * radius;
    for (int c = 0; c < s; ++c) {
        const float cx = centers[3 * c], cy = centers[3 * c + 1], cz = centers[3 * c + 2];
        int cnt = 0;
        int first = 0;
        for (int i = 0; i < n && cnt < k; ++i) {
            const float dx = xyz[3 * i] - cx;
            const float dy = xyz[3 * i + 1] - cy;
            const float dz = xyz[3 * i + 2] - cz;
            if (dx * dx + dy * dy + dz * dz < r2) {
                if (cnt == 0) first = i;
                out_idx[c * k + cnt++] = i;
            }
        }
        for (int j = cnt; j < k; ++j) out_idx[c * k + j] = cnt ? first : 0;
    }
}

// Three nearest neighbors + distances.
// unknown: (n, 3), known: (m, 3), out_d: (n, 3), out_i: (n, 3).
void three_nn(const float* unknown, int n, const float* known, int m,
              float* out_d, int32_t* out_i) {
    for (int i = 0; i < n; ++i) {
        float b0 = FLT_MAX, b1 = FLT_MAX, b2 = FLT_MAX;
        int i0 = 0, i1 = 0, i2 = 0;
        const float ux = unknown[3 * i], uy = unknown[3 * i + 1], uz = unknown[3 * i + 2];
        for (int j = 0; j < m; ++j) {
            const float dx = known[3 * j] - ux;
            const float dy = known[3 * j + 1] - uy;
            const float dz = known[3 * j + 2] - uz;
            const float d = dx * dx + dy * dy + dz * dz;
            if (d < b0) { b2 = b1; i2 = i1; b1 = b0; i1 = i0; b0 = d; i0 = j; }
            else if (d < b1) { b2 = b1; i2 = i1; b1 = d; i1 = j; }
            else if (d < b2) { b2 = d; i2 = j; }
        }
        out_d[3 * i] = sqrtf(b0); out_d[3 * i + 1] = sqrtf(b1); out_d[3 * i + 2] = sqrtf(b2);
        out_i[3 * i] = i0; out_i[3 * i + 1] = i1; out_i[3 * i + 2] = i2;
    }
}

// ---------------------------------------------------------------------
// Binary record codec: sequence of (n_points, n_dims, payload) float32
// blocks. Used by the expert-data loader to stream clouds without pickle
// overhead. Format per record: int32 n, int32 d, n*d float32.
// ---------------------------------------------------------------------

int write_records(const char* path, const float* data, const int32_t* sizes,
                  int n_records, int dims) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    int64_t off = 0;
    for (int r = 0; r < n_records; ++r) {
        const int32_t n = sizes[r];
        fwrite(&n, sizeof(int32_t), 1, f);
        const int32_t d = dims;
        fwrite(&d, sizeof(int32_t), 1, f);
        fwrite(data + off, sizeof(float), (size_t)n * dims, f);
        off += (int64_t)n * dims;
    }
    fclose(f);
    return n_records;
}

// Count records (for allocation). Returns number of records, fills
// total_points with the sum of n over records.
int count_records(const char* path, int64_t* total_points) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int count = 0;
    *total_points = 0;
    int32_t hdr[2];
    while (fread(hdr, sizeof(int32_t), 2, f) == 2) {
        *total_points += hdr[0];
        if (fseek(f, (long)hdr[0] * hdr[1] * sizeof(float), SEEK_CUR) != 0) break;
        ++count;
    }
    fclose(f);
    return count;
}

// Read all records into a preallocated buffer; sizes gets per-record n.
int read_records(const char* path, float* out, int32_t* sizes, int max_records) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int count = 0;
    int64_t off = 0;
    int32_t hdr[2];
    while (count < max_records && fread(hdr, sizeof(int32_t), 2, f) == 2) {
        const size_t n = (size_t)hdr[0] * hdr[1];
        if (fread(out + off, sizeof(float), n, f) != n) break;
        sizes[count] = hdr[0];
        off += n;
        ++count;
    }
    fclose(f);
    return count;
}

}  // extern "C"
