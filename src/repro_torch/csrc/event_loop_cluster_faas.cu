// The K-node form of the event-loop kernel (K0) for the policy codes 6 and 7:
// FaasCache and OpenWhisk-v2. Everything is in
// event_loop.cu; this unit instantiates only these variants'
// `Lane<P, true>` and their entries, so that nvcc builds them beside the
// other units.
#define K0_CLUSTER_VARIANTS(X) X(6, FaasP) X(7, Owv2P)
#include "event_loop.cu"
