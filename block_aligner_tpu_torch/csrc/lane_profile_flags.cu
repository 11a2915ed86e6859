// The FLAGS instances of the profile library (csrc/lane_profile.cu): the
// local-start, free-query-start-gap and free-query-end-gap flags for
// (query, profile) pairs, read from lane_align_launch's `flags`.
#define LANE_PROFILE true
#define LANE_FLAGS true
#include "lane_kernel.cu"
