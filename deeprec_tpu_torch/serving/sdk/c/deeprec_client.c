/* See deeprec_client.h. */
#define _POSIX_C_SOURCE 200112L /* getaddrinfo & friends under -std=c99 */
#include "deeprec_client.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

int dr_client_init(dr_client* c, const char* host, int port,
                   int timeout_ms) {
  if (!c || !host || strlen(host) >= sizeof(c->host)) return -1;
  strncpy(c->host, host, sizeof(c->host) - 1);
  c->host[sizeof(c->host) - 1] = '\0';
  c->port = port;
  c->timeout_ms = timeout_ms > 0 ? timeout_ms : 10000;
  return 0;
}

static int dr_connect(const dr_client* c) {
  char portbuf[16];
  snprintf(portbuf, sizeof portbuf, "%d", c->port);
  struct addrinfo hints, *res = NULL;
  memset(&hints, 0, sizeof hints);
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  if (getaddrinfo(c->host, portbuf, &hints, &res) != 0 || !res) return -1;
  int fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0) {
    freeaddrinfo(res);
    return -1;
  }
  struct timeval tv = {c->timeout_ms / 1000, (c->timeout_ms % 1000) * 1000};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  if (connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
    close(fd);
    freeaddrinfo(res);
    return -1;
  }
  freeaddrinfo(res);
  return fd;
}

static int send_all(int fd, const char* p, size_t n) {
  while (n > 0) {
    ssize_t w = send(fd, p, n, 0);
    if (w <= 0) return -2;
    p += w;
    n -= (size_t)w;
  }
  return 0;
}

/* One HTTP/1.1 request; extracts status + copies the body into buf.
 * Handles Content-Length responses (what the server sends). */
static int dr_roundtrip(const dr_client* c, const char* method,
                        const char* path, const char* body, char* buf,
                        size_t buflen) {
  if (!buf || buflen == 0) return -5;
  int fd = dr_connect(c);
  if (fd < 0) return -1;

  size_t blen = body ? strlen(body) : 0;
  char head[512];
  int hn = snprintf(head, sizeof head,
                    "%s %s HTTP/1.1\r\n"
                    "Host: %s:%d\r\n"
                    "Content-Type: application/json\r\n"
                    "Content-Length: %zu\r\n"
                    "Connection: close\r\n\r\n",
                    method, path, c->host, c->port, blen);
  if (hn <= 0 || (size_t)hn >= sizeof head) {
    close(fd);
    return -2;
  }
  if (send_all(fd, head, (size_t)hn) != 0 ||
      (blen && send_all(fd, body, blen) != 0)) {
    close(fd);
    return -2;
  }

  /* Read the full response (Connection: close => until EOF). */
  size_t cap = 1 << 16, len = 0;
  char* resp = (char*)malloc(cap);
  if (!resp) {
    close(fd);
    return -3;
  }
  for (;;) {
    if (len + 4096 > cap) {
      cap *= 2;
      char* r2 = (char*)realloc(resp, cap);
      if (!r2) {
        free(resp);
        close(fd);
        return -3;
      }
      resp = r2;
    }
    ssize_t r = recv(fd, resp + len, 4096, 0);
    if (r < 0) {
      free(resp);
      close(fd);
      return -3;
    }
    if (r == 0) break;
    len += (size_t)r;
  }
  close(fd);
  resp[len < cap ? len : cap - 1] = '\0';

  int status = 0;
  if (sscanf(resp, "HTTP/%*s %d", &status) != 1) {
    free(resp);
    return -3;
  }
  char* body_start = strstr(resp, "\r\n\r\n");
  if (!body_start) {
    free(resp);
    return -3;
  }
  body_start += 4;
  size_t bodylen = len - (size_t)(body_start - resp);
  if (bodylen + 1 > buflen) {
    free(resp);
    return -5;
  }
  memcpy(buf, body_start, bodylen);
  buf[bodylen] = '\0';
  free(resp);
  return status == 200 ? 0 : -4;
}

int dr_health(const dr_client* c, char* buf, size_t buflen) {
  return dr_roundtrip(c, "GET", "/healthz", NULL, buf, buflen);
}

int dr_predict(const dr_client* c, const char* request_json, char* buf,
               size_t buflen) {
  return dr_roundtrip(c, "POST", "/v1/predict", request_json, buf,
                      buflen);
}
