"""Client authentication for remote connections — the port's copy of
greengage_tpu/runtime/auth.py (the pg_hba.conf + auth.c role). Host only.

  - Unix-socket connections are trusted (a local peer, PostgreSQL's
    default local trust line).
  - TCP connections must authenticate as a user from
    ``<database dir>/gg_hba.json`` through a challenge-response handshake
    (the md5/SCRAM role): the server stores sha256(salt || password); the
    client proves knowledge by returning sha256(nonce || stored hash) for
    a per-connection nonce, so the password never crosses the wire and a
    replayed proof is useless under a fresh nonce.

``add_user`` writes the user file (the createuser analog; the ``gg
useradd`` command comes with the CLI, ROADMAP Queue 1 item 11). The port's
in-memory Database keeps the file in its scratch directory (``db.path``).
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets


def _hba_path(cluster_dir: str) -> str:
    return os.path.join(cluster_dir, "gg_hba.json")


def _stored_hash(salt: str, password: str) -> str:
    return hashlib.sha256((salt + password).encode()).hexdigest()


def load_users(cluster_dir: str) -> dict:
    try:
        with open(_hba_path(cluster_dir)) as f:
            return json.load(f).get("users", {})
    except (OSError, ValueError):
        return {}


def add_user(cluster_dir: str, user: str, password: str) -> None:
    path = _hba_path(cluster_dir)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        doc = {"users": {}}
    salt = secrets.token_hex(8)
    doc.setdefault("users", {})[user] = {
        "salt": salt, "hash": _stored_hash(salt, password)}
    tmp = path + ".tmp"
    # the stored hash IS a login credential under this scheme
    # (pass-the-hash), so the file must be 0600 from its FIRST byte
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)


def challenge(users: dict, user: str, cluster_dir: str = "") -> dict:
    """Server side: build the handshake challenge. Unknown users get a
    DETERMINISTIC fake salt (HMAC of the username under a per-cluster
    secret — PG's SCRAM mock-authentication) so repeated probes can't
    distinguish real users by salt stability."""
    entry = users.get(user)
    if entry:
        salt = entry["salt"]
    else:
        salt = hashlib.sha256(
            (_cluster_secret(cluster_dir) + ":" + user).encode()
        ).hexdigest()[:16]
    return {"auth": "challenge", "salt": salt,
            "nonce": secrets.token_hex(16)}


def _cluster_secret(cluster_dir: str) -> str:
    """Stable per-cluster secret for mock challenges (created lazily,
    0600)."""
    path = os.path.join(cluster_dir or ".", ".gg_auth_secret")
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        sec = secrets.token_hex(16)
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
            with os.fdopen(fd, "w") as f:
                f.write(sec)
        except OSError:
            pass
        return sec


def prove(salt: str, nonce: str, password: str) -> str:
    """Client side: the proof for a challenge."""
    return hashlib.sha256(
        (nonce + _stored_hash(salt, password)).encode()).hexdigest()


def verify(users: dict, user: str, nonce: str, proof: str) -> bool:
    entry = users.get(user)
    if entry is None:
        return False
    want = hashlib.sha256((nonce + entry["hash"]).encode()).hexdigest()
    return secrets.compare_digest(want, proof)
