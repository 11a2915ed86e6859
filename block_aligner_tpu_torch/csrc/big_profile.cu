// The profile instances of csrc/big_kernel.cu, one library of their own:
// (query, profile) pairs, sequence-to-PSSM, with the local-start,
// free-query-start-gap and free-query-end-gap flags read from
// big_align_launch's `flags`.
#define BIG_FLAGS true
#define BIG_PROFILE true
#include "big_kernel.cu"
