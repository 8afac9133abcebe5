// The traced K-node form of the event-loop kernel (K0) for the policy codes 6
// and 7: FaasCache and OpenWhisk-v2. As event_loop_cluster_faas.cu, with the
// trace rail compiled in (K0_TRACED: one record a processed event into a per-
// lane window of the record buffers; event_loop.cu's header), so that the
// untraced units compile as they did.
#define K0_TRACED 1
#define K0_CLUSTER_VARIANTS(X) X(6, FaasP) X(7, Owv2P)
#include "event_loop.cu"
