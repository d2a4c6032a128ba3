"""Self-signed CA + serving-cert minting for the webhook HTTPS server.

The port's copy of kubeflow_tpu/kube/certs.py.

The reference gets webhook TLS from the OpenShift service-CA operator (the
`service.beta.openshift.io/serving-cert-secret-name` annotation on the
webhook Service) and envtest generates local certs for its webhook server
(odh suite_test.go:121-124, WebhookInstallOptions).  This module is the
local analog: a throwaway CA signs a server cert for the given SANs, so
tests and standalone mode can serve real TLS without cluster infrastructure.
Uses the `cryptography` package (baked into the image).
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
from dataclasses import dataclass
from typing import Optional

from ..utils.clock import Clock


@dataclass
class CertBundle:
    ca_cert_pem: bytes
    cert_pem: bytes
    key_pem: bytes

    def write(self, cert_dir: str, prefix: str = "tls") -> tuple[str, str, str]:
        """Write tls.crt/tls.key/ca.crt into cert_dir (the layout
        controller-runtime's webhook server expects), returns the paths."""
        os.makedirs(cert_dir, exist_ok=True)
        paths = (
            os.path.join(cert_dir, f"{prefix}.crt"),
            os.path.join(cert_dir, f"{prefix}.key"),
            os.path.join(cert_dir, "ca.crt"),
        )
        for path, data in zip(paths, (self.cert_pem, self.key_pem,
                                      self.ca_cert_pem)):
            with open(path, "wb") as f:
                f.write(data)
        os.chmod(paths[1], 0o600)
        return paths

    def server_ssl_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        # a context needs files on disk; keep them in a private tmpdir
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            cert, key, _ = self.write(d)
            ctx.load_cert_chain(cert, key)
        return ctx

    def client_ssl_context(self) -> ssl.SSLContext:
        import tempfile

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        with tempfile.TemporaryDirectory() as d:
            ca = os.path.join(d, "ca.crt")
            with open(ca, "wb") as f:
                f.write(self.ca_cert_pem)
            ctx.load_verify_locations(ca)
        return ctx


def mint_serving_cert(
    common_name: str = "kubeflow-tpu-webhook",
    dns_names: tuple[str, ...] = ("localhost",),
    ip_addresses: tuple[str, ...] = ("127.0.0.1",),
    valid_days: int = 7,
    clock: Optional[Clock] = None,
) -> CertBundle:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    # injected clock: cert validity anchors to the caller's time source
    # (a real Clock in production; tests can mint from a FakeClock)
    now = datetime.datetime.fromtimestamp(
        (clock or Clock()).now(), datetime.timezone.utc)
    not_after = now + datetime.timedelta(days=valid_days)

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, f"{common_name}-ca")])
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name).issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now).not_valid_after(not_after)
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .sign(ca_key, hashes.SHA256())
    )

    key = ec.generate_private_key(ec.SECP256R1())
    sans: list[x509.GeneralName] = [x509.DNSName(d) for d in dns_names]
    sans += [x509.IPAddress(ipaddress.ip_address(ip)) for ip in ip_addresses]
    cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]))
        .issuer_name(ca_name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now).not_valid_after(not_after)
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .sign(ca_key, hashes.SHA256())
    )

    pem = serialization.Encoding.PEM
    return CertBundle(
        ca_cert_pem=ca_cert.public_bytes(pem),
        cert_pem=cert.public_bytes(pem),
        key_pem=key.private_bytes(
            pem,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ),
    )


__all__ = ["CertBundle", "mint_serving_cert"]
