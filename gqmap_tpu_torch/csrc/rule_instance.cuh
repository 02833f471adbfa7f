// The launch path of the kernels with rule instances: K3 (edge_gq.cu) and v1
// of K10 and K11 (quad_gq.cu).
//
// Such a kernel is a template on its rule type Rule<T, K>. The instance for
// a rule of the main path (K = 9, and K = 11 for K3) takes the rule by value:
// a kernel parameter in the constant bank that feeds the operations with no
// load. The generic instance, Rule<T, 0> (an empty type), reads the same
// values from a device array and stages them into shared memory once a block.
// The Python side (kernels/build.py rule_args) gives exactly one of them:
// rule_host (the values on the host) selects the instance compiled for K,
// rule_dev (on the card) the generic one.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>
#include <type_traits>

namespace gqmap {

constexpr size_t kRuleSharedBytes = 48 * 1024;  // static launch limit without opt-in

// A compiled instance's rule, copied from its values on the host.
template <typename Rule>
Rule rule_from_host(const void* host) {
  static_assert(std::is_trivially_copyable<Rule>::value, "rule must be a plain struct");
  Rule rule;
  std::memcpy(&rule, host, sizeof rule);
  return rule;
}

// Set the device and launch the instance the rule selects:
// go(rule, tab, smem) with the generic instance's empty Rule<T, 0>, the device
// values and `generic_smem` bytes of shared memory, or with Rule<T, K> (K one of
// Ks) copied from the host, a null tab and none. Returns the cudaError_t as
// an int: an invalid value for K < 2, both or neither of rule_host and
// rule_dev, a generic instance over the shared-memory limit or a K with no
// instance; else the launch's error.
template <template <typename, int> class Rule, typename T, int... Ks, typename Go>
int launch_rule_instance(const void* rule_host, const void* rule_dev, int K, int device,
                         size_t generic_smem, Go&& go) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 2 || (rule_host == nullptr) == (rule_dev == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rule_dev != nullptr) {
    if (generic_smem > kRuleSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
    go(Rule<T, 0>{}, static_cast<const T*>(rule_dev), generic_smem);
  } else {
    const T* none = nullptr;
    const bool found =
        ((K == Ks && (go(rule_from_host<Rule<T, Ks>>(rule_host), none, size_t(0)), true)) ||
         ...);
    if (!found) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gqmap
