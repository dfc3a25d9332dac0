"""The embedded HTTP server the serving door and the trainer's telemetry
door ride."""


def http_get(host: str, port: int, path: str, timeout: float) -> bytes:
    """One bounded GET against a daemon's admin door (the elastic
    controller's doctor poll). Raises ``IOError`` on any non-200."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise IOError(f"{path} -> HTTP {resp.status}")
        return body
    finally:
        conn.close()
