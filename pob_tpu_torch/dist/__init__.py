"""Multi-device layer: proof-batch data parallelism, MSM point sharding with
a collective reduction, the four-step distributed NTT, the mesh-sharded
prove and the pipelined prover, the counterparts of pob_tpu/dist. One
process drives a mesh of torch devices (``mesh.Mesh``); a mesh may repeat a
device, which gives a virtual mesh on one card or on the CPU."""
