// The K-node form of the event-loop kernel (K0) for the policy codes 0 and 1:
// ESFF, and ESFF with ESFF-H's cold-aware drain. Everything is in
// event_loop.cu; this unit instantiates only these variants'
// `Lane<P, true>` and their entries, so that nvcc builds them beside the
// other units.
#define K0_CLUSTER_VARIANTS(X) X(0, EsffP) X(1, EsffColdP)
#include "event_loop.cu"
