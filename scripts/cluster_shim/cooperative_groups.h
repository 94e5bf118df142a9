// The cluster part of cooperative_groups for the CPU stand-in
// (cuda_runtime.h beside it): a cluster barrier and map_shared_rank over
// the simulated blocks' shared memories.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return shim::ctx.rank; }
  unsigned num_blocks() const {
    return static_cast<unsigned>(shim::ctx.cluster->blocks.size());
  }
  void sync() const { shim::ctx.cluster->bar->arrive_and_wait(); }
  template <typename T>
  T* map_shared_rank(T* p, unsigned rank) const {
    const char* mine = reinterpret_cast<char*>(shim::ctx.block->base());
    char* theirs =
        reinterpret_cast<char*>(shim::ctx.cluster->blocks[rank]->base());
    return reinterpret_cast<T*>(theirs +
                                (reinterpret_cast<const char*>(p) - mine));
  }
};
inline cluster_group this_cluster() { return cluster_group{}; }
}  // namespace cooperative_groups
