// K1's cluster form: the whole-decode kernel of fused_bamp_decode.cu with
// one trial spread over a thread-block cluster of 2, 4 or 8 blocks, built
// from that source with K1_CLUSTER set into a library of its own
// (fused_bamp.py::whole_decode loads it where cluster_plan gives more than
// one block a trial).  Replaces no TPU kernel of its own: it is K1
// (amp_sparc_spatialmodulation_tpu/ops/pallas/fused_bamp.py::
// _decode_kernel) where one Hopper block's 227 KB of shared memory holds
// no trial and JAX's kernel, on the TPU's larger VMEM, takes the batch.
#define K1_CLUSTER 1
#include "fused_bamp_decode.cu"
