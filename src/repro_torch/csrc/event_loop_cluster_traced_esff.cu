// The traced K-node form of the event-loop kernel (K0) for the policy codes 0
// and 1: ESFF, and ESFF with ESFF-H's cold-aware drain. As
// event_loop_cluster_esff.cu, with the trace rail compiled in (K0_TRACED: one
// record a processed event into a per-lane window of the record buffers;
// event_loop.cu's header), so that the untraced units compile as they did.
#define K0_TRACED 1
#define K0_CLUSTER_VARIANTS(X) X(0, EsffP) X(1, EsffColdP)
#include "event_loop.cu"
