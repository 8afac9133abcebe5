// The K-node form of the event-loop kernel (K0) for the policy codes 4 and 5:
// the central queue in both orders (OpenWhisk, SFF). Everything is in
// event_loop.cu; this unit instantiates only these variants'
// `Lane<P, true>` and their entries, so that nvcc builds them beside the
// other units.
#define K0_CLUSTER_VARIANTS(X) X(4, FifoP) X(5, SffP)
#include "event_loop.cu"
