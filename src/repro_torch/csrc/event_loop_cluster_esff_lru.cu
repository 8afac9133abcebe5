// The K-node form of the event-loop kernel (K0) for the policy codes 2 and 3:
// ESFF with the LRU victim, and ESFF-H. Everything is in
// event_loop.cu; this unit instantiates only these variants'
// `Lane<P, true>` and their entries, so that nvcc builds them beside the
// other units.
#define K0_CLUSTER_VARIANTS(X) X(2, EsffLruP) X(3, EsffHP)
#include "event_loop.cu"
