"""Encryption at rest, client side: the AES-CTR streams, key providers
and the KMS's REST client. ``cryptography`` is imported only where a
cipher is built."""

from hadoop_tpu_torch.crypto.keys import (FileKeyProvider,  # noqa: F401
                                          KeyProvider, KMSClientProvider,
                                          make_provider)
from hadoop_tpu_torch.crypto.kms import KMSKeyProvider  # noqa: F401
from hadoop_tpu_torch.crypto.streams import (CryptoInputStream,  # noqa: F401
                                             CryptoOutputStream)
