"""The lane-batched scheduling engine (`engine`), its policy kernels
(`policies`) and the request/trace data model (`request`)."""
