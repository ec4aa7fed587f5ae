// The level loop's control block: int32 words in device memory, one block
// per loop (bfs_tpu_torch/ops/control.py mirrors the indices and the size).
//
// Every loop kernel takes a pointer to it (null outside the block loop:
// always live) and returns at entry when the superstep is not live; the
// update kernels read the level they stamp from it and raise its flag; the
// control step (loop_control, relay_kernels.cu) ends each superstep.

#pragma once

#include <cstdint>

constexpr int kCtlLevel = 0;    // levels run so far
constexpr int kCtlChanged = 1;  // the last live superstep changed something
constexpr int kCtlLive = 2;     // the next superstep runs: changed && level < cap
constexpr int kCtlCap = 3;      // the loop's level bound
constexpr int kCtlSteps = 4;    // live supersteps, counted on the device
// Raised by the superstep's update, cleared by the control step: a 128-byte
// line of its own, so the update's blocks, which store to it, do not
// contend with every block's load of the words above.
constexpr int kCtlFlag = 32;

// The gated kernels only read the words they load here (the control step,
// a kernel of its own, writes them), so the loads take the read-only path.
__device__ __forceinline__ int32_t ctl_word(const int32_t* ctl, int word) {
  return __ldg(ctl + word);
}

// True when the superstep gated by `ctl` is not live.  Block-uniform: call
// it before any barrier.
__device__ __forceinline__ bool superstep_dead(const int32_t* ctl) {
  return ctl != nullptr && ctl_word(ctl, kCtlLive) == 0;
}
