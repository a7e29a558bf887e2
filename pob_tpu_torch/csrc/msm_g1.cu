// K3 on G1 (coordinates over Fq); the kernels are in msm.cuh.
#define POB_MSM_T Fe
#include "msm.cuh"
