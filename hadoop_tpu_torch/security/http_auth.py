"""HTTP authentication filter — the hadoop-auth analog.

The counterpart of ``hadoop_tpu/security/http_auth.py``: the filter wraps
an ``HttpServer`` handler; an unauthenticated request either presents
``?user.name=`` (pseudo authentication) and receives a signed
``hadoop.auth`` token cookie, or replays a cookie issued before; a
tampered or expired cookie is refused with 401. The cookie is the
reference's byte for byte (urlsafe base64 of the JSON ``{"u": user,
"e": expiry}``, a dot, the hex HMAC-SHA256 of that JSON), so a cookie
either package signs is accepted by the other under the same secret."""

from __future__ import annotations

import base64
import hmac
import hashlib
import json
import logging
import time
from typing import Callable, Dict, Optional, Tuple

log = logging.getLogger(__name__)

COOKIE_NAME = "hadoop.auth"


class AuthenticationToken:
    """Signed (user, expiry) token. Ref: hadoop-auth
    AuthenticationToken.java + util/Signer.java."""

    def __init__(self, user: str, expires: float):
        self.user = user
        self.expires = expires

    def sign(self, secret: bytes) -> str:
        body = json.dumps({"u": self.user, "e": self.expires}).encode()
        mac = hmac.new(secret, body, hashlib.sha256).hexdigest()
        return base64.urlsafe_b64encode(body).decode() + "." + mac

    @classmethod
    def verify(cls, signed: str, secret: bytes
               ) -> Optional["AuthenticationToken"]:
        try:
            b64, _, mac = signed.partition(".")
            body = base64.urlsafe_b64decode(b64)
            want = hmac.new(secret, body, hashlib.sha256).hexdigest()
            if not hmac.compare_digest(mac, want):
                return None
            d = json.loads(body)
            tok = cls(d["u"], float(d["e"]))
            if tok.expires < time.time():
                return None
            return tok
        except (ValueError, KeyError, TypeError):
            return None


class AuthFilter:
    """Wraps HttpServer handlers with pseudo/token authentication.
    Ref: AuthenticationFilter.doFilter. Usage:

        filt = AuthFilter(secret)
        http.add_handler("/prot", filt.wrap(handler))

    The wrapped handler receives ``query["__user__"]``. Anonymous
    access is allowed iff ``allow_anonymous`` (the reference's
    simple.anonymous.allowed)."""

    def __init__(self, secret: bytes, token_validity_s: float = 36000.0,
                 allow_anonymous: bool = False):
        self.secret = secret
        self.validity = token_validity_s
        self.allow_anonymous = allow_anonymous

    def authenticate(self, query: Dict) -> Tuple[Optional[str],
                                                 Optional[str]]:
        """(user, fresh-cookie-or-None); user None = unauthenticated."""
        cookie = query.get("__cookie__", "")
        for part in cookie.split(";"):
            name, _, value = part.strip().partition("=")
            if name == COOKIE_NAME:
                tok = AuthenticationToken.verify(value, self.secret)
                if tok is not None:
                    return tok.user, None
        user = query.get("user.name")
        if user:
            fresh = AuthenticationToken(
                user, time.time() + self.validity).sign(self.secret)
            return user, fresh
        if self.allow_anonymous:
            return "anonymous", None
        return None, None

    def wrap(self, handler: Callable) -> Callable:
        def wrapped(query: Dict, body: bytes):
            user, fresh = self.authenticate(query)
            if user is None:
                return 401, {"RemoteException": {
                    "exception": "AuthenticationException",
                    "message": "authentication required "
                               "(?user.name= or hadoop.auth cookie)"}}
            query["__user__"] = user
            out = handler(query, body)
            if fresh is not None:
                status, payload = out[0], out[1]
                headers = dict(out[2]) if len(out) == 3 else {}
                headers["Set-Cookie"] = \
                    f"{COOKIE_NAME}={fresh}; HttpOnly"
                return status, payload, headers
            return out
        return wrapped



def ugi_for_query(query) -> "UserGroupInformation":
    """The UGI a REST handler acts as (WebHDFS): the AuthFilter's
    authenticated principal (``__user__``) outranks the pseudo-auth
    ``user.name`` parameter, and an anonymous or absent identity is the
    unprivileged default ``dr.who``."""
    from hadoop_tpu_torch.security.ugi import UserGroupInformation
    user = query.get("__user__")
    if user in (None, "", "anonymous"):
        user = query.get("user.name") or "dr.who"
    return UserGroupInformation.create_remote_user(user)
