// The paired 1-D Gauss-Hermite rule by value: kernel K2 (edge_reduced_gq.cu)
// and kernel K15 v2 (autodiff_gq.cu), the reduced Charbonnier edges.
//
// The values are kernels/edge_reduced_gq.py::paired_rule_1d's, in its order:
// for each of the K1 / 2 pairs of nodes +-x the node x > 0, w, w x and
// w (x^2 - 1/2), then the centre weight (0 for even K1). A compiled K1 takes
// them as a kernel parameter in the constant bank; EdgeRule1D<T, 0>, the
// generic instance, reads the same values from a device array.

#pragma once

namespace gqmap {

template <typename T, int K1>
struct EdgeRule1D {
  static constexpr int kPairs = K1 / 2;
  T x[kPairs], w[kPairs], wx[kPairs], wq[kPairs];
  T wc;
};
template <typename T>
struct EdgeRule1D<T, 0> {};  // the generic instance reads the rule from shared memory

// Kernel parameters live in the constant bank: within the classic 4 KB limit.
static_assert(sizeof(EdgeRule1D<double, 25>) + 128 <= 4096, "rule exceeds parameter space");
static_assert(sizeof(EdgeRule1D<float, 21>) == 41 * sizeof(float), "not the flat rule's layout");

}  // namespace gqmap
