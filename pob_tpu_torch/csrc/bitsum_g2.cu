// K5 on G2 (coordinates over Fq2); the kernels are in bitsum.cuh.
#define POB_BITSUM_T Fq2
#include "bitsum.cuh"
