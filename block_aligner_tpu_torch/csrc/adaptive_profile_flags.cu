// The FLAGS instances of the profile library (csrc/adaptive_profile.cu):
// the local-start, free-query-start-gap and free-query-end-gap flags for
// (query, profile) pairs, read from adaptive_align_launch's `flags`.
#define ADAPTIVE_PROFILE true
#define ADAPTIVE_FLAGS true
#include "adaptive_kernel.cu"
