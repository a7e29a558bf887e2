"""Multi-device layer: proof-batch data parallelism, MSM point sharding with
a collective reduction, the four-step distributed NTT, the mesh-sharded
prove and the pipelined prover, the counterparts of pob_tpu/dist. A mesh
(``mesh.Mesh``) is driven by one process, over torch devices that may
repeat (a virtual mesh on one card or on the CPU), or spans processes, one
rank and one shard each, after ``mesh.init_multihost`` (NCCL on the cards,
gloo on the CPU)."""
