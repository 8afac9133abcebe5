// The traced K-node form of the event-loop kernel (K0) for the policy codes 2
// and 3: ESFF with the LRU victim, and ESFF-H. As
// event_loop_cluster_esff_lru.cu, with the trace rail compiled in (K0_TRACED:
// one record a processed event into a per-lane window of the record buffers;
// event_loop.cu's header), so that the untraced units compile as they did.
#define K0_TRACED 1
#define K0_CLUSTER_VARIANTS(X) X(2, EsffLruP) X(3, EsffHP)
#include "event_loop.cu"
