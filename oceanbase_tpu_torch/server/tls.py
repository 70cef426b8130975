"""TLS for the wire frontend: self-signed server credentials generated
on first use and persisted under <root>/tls/.

Port of ``oceanbase_tpu/server/tls.py``, unchanged: the credentials come
from the ``cryptography`` module, else from the ``openssl`` binary, and
the private key file is created with mode 0600.  Reference analog: the
ussl-hook TLS upgrade on the MySQL/RPC ports (deps/ussl-hook) + ALTER
SYSTEM ssl configuration.  Operators can drop
their own PEM pair at the same paths to replace the self-signed one.
"""

from __future__ import annotations

import datetime
import os
import ssl


def ensure_server_credentials(root: str) -> tuple[str, str]:
    """-> (cert_path, key_path), generating a self-signed pair if absent."""
    tdir = os.path.join(root, "tls")
    cert_p = os.path.join(tdir, "server-cert.pem")
    key_p = os.path.join(tdir, "server-key.pem")
    if os.path.exists(cert_p) and os.path.exists(key_p):
        return cert_p, key_p
    os.makedirs(tdir, exist_ok=True)
    try:
        from cryptography import x509
    except ImportError:
        # minimal images ship no cryptography wheel; the openssl binary
        # generates an equivalent self-signed pair
        return _openssl_credentials(tdir, cert_p, key_p)
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         "oceanbase-tpu")])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=3650))
            .add_extension(x509.SubjectAlternativeName(
                [x509.DNSName("localhost")]), critical=False)
            .sign(key, hashes.SHA256()))
    # the unencrypted private key must never be world-readable, not
    # even between create and a later chmod: open with 0o600 atomically
    fd = os.open(key_p, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as fh:
        fh.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))
    with open(cert_p, "wb") as fh:
        fh.write(cert.public_bytes(serialization.Encoding.PEM))
    return cert_p, key_p


def _openssl_credentials(tdir: str, cert_p: str, key_p: str
                         ) -> tuple[str, str]:
    """Self-signed pair via the openssl CLI (fallback when the
    ``cryptography`` module is unavailable)."""
    import shutil
    import subprocess

    exe = shutil.which("openssl")
    if exe is None:
        raise RuntimeError(
            "TLS credentials need either the 'cryptography' module or "
            "an openssl binary; neither is available")
    base = [exe, "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", key_p, "-out", cert_p, "-days", "3650",
            "-subj", "/CN=oceanbase-tpu"]
    # -addext needs OpenSSL >= 1.1.1; LibreSSL/older builds still make a
    # usable self-signed pair without the SAN
    for cmd in (base + ["-addext", "subjectAltName=DNS:localhost"], base):
        # umask guards the window while openssl holds the key file open
        # (a post-hoc chmod would leave it world-readable mid-write)
        old_umask = os.umask(0o177)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        finally:
            os.umask(old_umask)
        if r.returncode == 0:
            os.chmod(key_p, 0o600)
            os.chmod(cert_p, 0o644)  # certs are public
            return cert_p, key_p
    raise RuntimeError(
        f"openssl self-signed certificate generation failed: "
        f"{r.stderr.strip()[:500]}")


def server_context(root: str) -> ssl.SSLContext:
    cert_p, key_p = ensure_server_credentials(root)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_p, key_p)
    return ctx
