// Linear sum assignment (square matrices) via the shortest-augmenting-path
// Hungarian algorithm with row/column potentials — the same O(n^3) family
// scipy's C++ solver implements. Host-side native component for PIT's
// large-speaker path (metrics_tpu_torch/functional/audio/pit.py). The same
// source as metrics_tpu/native/lsap.cpp, kept in the port's own tree.
//
// Built at first use by metrics_tpu_torch/native/__init__.py into
// metrics_tpu_torch/_build/:
//   g++ -O3 -shared -fPIC lsap.cpp -o lsap-<hash>.so

#include <cstddef>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

// Assign each row of the n x n cost matrix `a` (row-major) to a distinct
// column minimizing total cost; writes the column of each row.
void solve_one(const double* a, int n, int32_t* col_of_row) {
    const double INF = std::numeric_limits<double>::infinity();
    std::vector<double> u(n, 0.0);       // row potentials
    std::vector<double> v(n + 1, 0.0);   // column potentials (n = virtual col)
    std::vector<int> p(n + 1, -1);       // p[j]: row matched to column j
    std::vector<int> way(n + 1, -1);     // predecessor column on the path

    for (int i = 0; i < n; ++i) {
        std::vector<double> minv(n + 1, INF);
        std::vector<char> used(n + 1, 0);
        int j0 = n;
        p[n] = i;
        do {
            used[j0] = 1;
            const int i0 = p[j0];
            double delta = INF;
            int j1 = -1;
            for (int j = 0; j < n; ++j) {
                if (used[j]) continue;
                const double cur = a[static_cast<size_t>(i0) * n + j] - u[i0] - v[j];
                if (cur < minv[j]) {
                    minv[j] = cur;
                    way[j] = j0;
                }
                if (minv[j] < delta) {
                    delta = minv[j];
                    j1 = j;
                }
            }
            for (int j = 0; j <= n; ++j) {
                if (used[j]) {
                    if (p[j] >= 0) u[p[j]] += delta;
                    v[j] -= delta;
                } else {
                    minv[j] -= delta;
                }
            }
            j0 = j1;
        } while (p[j0] != -1);

        while (j0 != n) {  // augment along the stored path
            const int j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        }
        p[n] = -1;
    }

    for (int j = 0; j < n; ++j) col_of_row[p[j]] = j;
}

}  // namespace

extern "C" {

// costs: [batch, n, n] row-major doubles; out: [batch, n] int32 column of
// each row. Returns 0 on success.
int lsap_batch(const double* costs, int batch, int n, int32_t* out) {
    if (n <= 0 || batch < 0) return 1;
    for (int b = 0; b < batch; ++b) {
        solve_one(costs + static_cast<size_t>(b) * n * n, n,
                  out + static_cast<size_t>(b) * n);
    }
    return 0;
}

}  // extern "C"
