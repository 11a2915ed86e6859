// The profile instances of csrc/lane_kernel.cu (sequence-to-PSSM
// alignment), one library of their own: its lane_align_launch reads the
// queries' codes and the profiles' packed words (ops/_profile.py).
#define LANE_PROFILE true
#include "lane_kernel.cu"
