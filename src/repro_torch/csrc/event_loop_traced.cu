// The traced single-node form of the event-loop kernel (K0), every policy
// variant: event_loop.cu with the trace rail compiled in (K0_TRACED: one
// record a processed event into a per-lane window of the record buffers;
// event_loop.cu's header), so that the untraced library compiles as it
// did. Its entries are event_loop_traced_run and event_loop_layout.
#define K0_TRACED 1
#include "event_loop.cu"
