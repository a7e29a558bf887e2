// K3 on G2 (coordinates over Fq2); the kernels are in msm.cuh.
#define POB_MSM_T Fq2
#include "msm.cuh"
