/* C client SDK for the deeprec_tpu_torch serving endpoint.
 *
 * A copy of deeprec_tpu/serving/sdk/c/deeprec_client.h: the wire
 * protocol is the same. A tiny native library any RPC framework can
 * link to score against a running HttpScorer or the worker the C ABI
 * processor spawns. C99 + POSIX sockets, no dependencies.
 *
 * All functions return 0 on success, negative on error:
 *   -1 connect/resolve failure   -2 send failure
 *   -3 recv/protocol failure     -4 server returned non-200
 *   -5 response buffer too small
 */
#ifndef DEEPREC_CLIENT_H_
#define DEEPREC_CLIENT_H_

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  char host[256];
  int port;
  int timeout_ms; /* per-request socket timeout */
} dr_client;

/* initialize() analog: fill in the handle (no connection is held;
 * each request uses one short-lived connection). */
int dr_client_init(dr_client* c, const char* host, int port,
                   int timeout_ms);

/* GET /healthz. Writes the raw JSON body into buf (NUL-terminated). */
int dr_health(const dr_client* c, char* buf, size_t buflen);

/* process() analog: POST /v1/predict with request_json (a complete
 * {"instances": [...]} document); writes the raw JSON response body
 * ({"predictions": [...]}) into buf (NUL-terminated). */
int dr_predict(const dr_client* c, const char* request_json, char* buf,
               size_t buflen);

#ifdef __cplusplus
}
#endif

#endif /* DEEPREC_CLIENT_H_ */
