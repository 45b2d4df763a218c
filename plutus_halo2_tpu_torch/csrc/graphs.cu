// Host-only entry points (no kernels): over a captured CUDA graph, the
// census of its nodes by type, the event-record nodes with the events they
// record, and re-pointing those nodes of an instantiated graph to other
// events before a launch (models/programs.py); and an event's record on a
// stream (utils/tracing.py).
#include <cuda_runtime.h>

#include <vector>

// counts[0..4]: kernel, memcpy, memset, event (record and wait) and other
// nodes. The first max_events event-record nodes and their events go to
// nodes[] and events[]; n_events gets the number of event-record nodes.
extern "C" int ph2_graph_census(void* graph, long long* counts, void** nodes, void** events, int max_events,
                                int* n_events) {
  cudaGraph_t g = (cudaGraph_t)graph;
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return (int)e;
  std::vector<cudaGraphNode_t> all(n);
  if (n) {
    e = cudaGraphGetNodes(g, all.data(), &n);
    if (e != cudaSuccess) return (int)e;
  }
  for (int k = 0; k < 5; ++k) counts[k] = 0;
  int found = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(all[i], &t);
    if (e != cudaSuccess) return (int)e;
    switch (t) {
      case cudaGraphNodeTypeKernel: counts[0]++; break;
      case cudaGraphNodeTypeMemcpy: counts[1]++; break;
      case cudaGraphNodeTypeMemset: counts[2]++; break;
      case cudaGraphNodeTypeWaitEvent: counts[3]++; break;
      case cudaGraphNodeTypeEventRecord: {
        counts[3]++;
        if (found < max_events) {
          cudaEvent_t ev;
          e = cudaGraphEventRecordNodeGetEvent(all[i], &ev);
          if (e != cudaSuccess) return (int)e;
          nodes[found] = (void*)all[i];
          events[found] = (void*)ev;
        }
        found++;
        break;
      }
      default: counts[4]++;
    }
  }
  *n_events = found;
  return (int)cudaSuccess;
}

// Re-points n event-record nodes of an instantiated graph: node i records
// events[i] from the next launch on (launches already queued keep theirs).
extern "C" int ph2_graph_set_events(void* exec, void* const* nodes, void* const* events, int n) {
  for (int i = 0; i < n; ++i) {
    cudaError_t e = cudaGraphExecEventRecordNodeSetEvent((cudaGraphExec_t)exec, (cudaGraphNode_t)nodes[i],
                                                         (cudaEvent_t)events[i]);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// Records event on stream (a traced call's eager events).
extern "C" int ph2_event_record(void* event, void* stream) {
  return (int)cudaEventRecord((cudaEvent_t)event, (cudaStream_t)stream);
}
