// K5 on G1 (coordinates over Fq); the kernels are in bitsum.cuh.
#define POB_BITSUM_T Fe
#include "bitsum.cuh"
