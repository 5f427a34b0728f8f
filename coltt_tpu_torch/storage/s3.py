"""Network object store: an S3/MinIO client over HTTP with SigV4 auth.

Port of ``coltt_tpu/storage/s3.py``, the same code: the port keeps its own
copy so that it never imports the JAX package. Reference parity:
``pkg/minio`` — the reference talks to a real MinIO server over the
network (bucket CRUD + versioning enable + versioned cleanup,
bucket_handler.go:33-130; object put/get, object_handler.go:29-51) with
hardcoded ``minioadmin`` credentials and endpoint (edge/edge.go:36). This
client speaks the same S3 REST dialect (path-style addressing, AWS
Signature v4) so edge / experimental checkpoints can live on a MinIO / S3
service and survive host loss; ``LocalObjectStore`` stays the
zero-dependency default.

Pure stdlib (http.client + hashlib/hmac + ElementTree): SigV4 is ~60 lines
and the surface the engines need is small. The method surface is
interface-compatible with
:class:`coltt_tpu_torch.storage.objectstore.LocalObjectStore` (streamed
``put_object_stream`` through a multipart upload, streamed
``open_object``); ``build_servicer`` picks the backend from ``[storage]
object_store``.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import urllib.parse
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple


class S3Error(Exception):
    def __init__(self, status: int, body: bytes = b""):
        self.status = status
        super().__init__(f"S3 request failed: HTTP {status} {body[:200]!r}")


def _uri_encode(s: str, *, encode_slash: bool = True) -> str:
    safe = "~-._" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


class _StreamingBody:
    """File-like over an open HTTP response; closes the connection with it."""

    def __init__(self, resp, conn):
        self._resp = resp
        self._conn = conn

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            return self._resp.read()
        # http.client may return short reads; snapshot decoders expect
        # exact counts (np.frombuffer) — loop to n or EOF
        chunks, got = [], 0
        while got < n:
            b = self._resp.read(n - got)
            if not b:
                break
            chunks.append(b)
            got += len(b)
        return b"".join(chunks)

    def close(self) -> None:
        try:
            self._resp.close()
        finally:
            self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class S3ObjectStore:
    """Minimal S3 client with the LocalObjectStore surface.

    ``endpoint`` is ``host:port`` (MinIO default ``localhost:9000``,
    matching the reference's hardcoded dial target, edge/edge.go:36).
    """

    def __init__(
        self,
        endpoint: str = "localhost:9000",
        access_key: str = "minioadmin",   # reference default creds
        secret_key: str = "minioadmin",   # (pkg/minio/bucket_handler.go:33)
        *,
        region: str = "us-east-1",
        secure: bool = False,
        timeout: float = 30.0,
    ):
        self.endpoint = endpoint
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.secure = secure
        self.timeout = timeout

    # -- SigV4 ----------------------------------------------------------------
    def _sign(
        self, method: str, path: str, query: List[Tuple[str, str]],
        payload_hash: str, amzdate: str,
    ) -> Dict[str, str]:
        datestamp = amzdate[:8]
        canonical_q = "&".join(
            f"{_uri_encode(k)}={_uri_encode(v)}"
            for k, v in sorted(query)
        )
        headers = {
            "host": self.endpoint,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amzdate,
        }
        signed = ";".join(sorted(headers))
        canonical_h = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
        creq = "\n".join([
            method, _uri_encode(path, encode_slash=False), canonical_q,
            canonical_h, signed, payload_hash,
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        sts = "\n".join([
            "AWS4-HMAC-SHA256", amzdate, scope,
            hashlib.sha256(creq.encode()).hexdigest(),
        ])

        def hm(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = hm(b"AWS4" + self.secret_key.encode(), datestamp)
        k = hm(k, self.region)
        k = hm(k, "s3")
        k = hm(k, "aws4_request")
        sig = hmac.new(k, sts.encode(), hashlib.sha256).hexdigest()
        return {
            "Host": self.endpoint,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amzdate,
            "Authorization": (
                f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope},"
                f"SignedHeaders={signed},Signature={sig}"
            ),
        }

    def _request(
        self, method: str, path: str,
        query: Optional[List[Tuple[str, str]]] = None,
        body: bytes = b"", ok: Tuple[int, ...] = (200, 204),
    ) -> Tuple[int, bytes, Dict[str, str]]:
        query = query or []
        amzdate = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ"
        )
        payload_hash = hashlib.sha256(body).hexdigest()
        headers = self._sign(method, path, query, payload_hash, amzdate)
        if body:
            headers["Content-Length"] = str(len(body))
        qs = urllib.parse.urlencode(query)
        url = _uri_encode(path, encode_slash=False) + (f"?{qs}" if qs else "")
        cls = http.client.HTTPSConnection if self.secure else http.client.HTTPConnection
        conn = cls(self.endpoint, timeout=self.timeout)
        try:
            conn.request(method, url, body=body or None, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            rh = {k.lower(): v for k, v in resp.getheaders()}
        finally:
            conn.close()
        if resp.status not in ok:
            raise S3Error(resp.status, data)
        return resp.status, data, rh

    @staticmethod
    def _xml(data: bytes) -> ET.Element:
        # strip namespaces so finds stay simple across S3/MinIO variants
        it = ET.iterparse(__import__("io").BytesIO(data))
        for _, el in it:
            el.tag = el.tag.rpartition("}")[2]
        return it.root

    # -- buckets -----------------------------------------------------------------
    def create_bucket(self, bucket: str, *, versioning: bool = False) -> None:
        self._request("PUT", f"/{bucket}", ok=(200, 204, 409))  # 409 = exists
        if versioning:
            cfg = (
                b'<VersioningConfiguration xmlns='
                b'"http://s3.amazonaws.com/doc/2006-03-01/">'
                b"<Status>Enabled</Status></VersioningConfiguration>"
            )
            self._request(
                "PUT", f"/{bucket}", query=[("versioning", "")], body=cfg
            )

    def bucket_exists(self, bucket: str) -> bool:
        try:
            self._request("HEAD", f"/{bucket}", ok=(200,))
            return True
        except S3Error as e:
            if e.status in (404, 403):
                return False
            raise

    def bucket_versioning(self, bucket: str) -> bool:
        _, data, _ = self._request(
            "GET", f"/{bucket}", query=[("versioning", "")], ok=(200,)
        )
        root = self._xml(data)
        status = root.find("Status")
        return status is not None and status.text == "Enabled"

    def list_buckets(self) -> List[str]:
        _, data, _ = self._request("GET", "/", ok=(200,))
        root = self._xml(data)
        return sorted(
            el.text for el in root.iter("Name") if el.text
        )

    def delete_bucket(self, bucket: str) -> None:
        if not self.bucket_exists(bucket):
            return
        # S3 requires an empty bucket: purge objects incl. all versions
        for name in self.list_objects(bucket):
            self.delete_object(bucket, name)
        self._request("DELETE", f"/{bucket}", ok=(200, 204, 404))

    # -- objects --------------------------------------------------------------------
    def put_object(self, bucket: str, name: str, data: bytes) -> None:
        self._request("PUT", f"/{bucket}/{name}", body=data, ok=(200,))

    _PART_SIZE = 16 << 20  # multipart part size (S3 minimum is 5 MB)

    def put_object_stream(self, bucket: str, name: str, writer) -> None:
        """PUT whose payload is produced by ``writer(file)`` — a multipart
        upload flushing ~16 MB parts as they fill, so a multi-GB checkpoint
        streams to the store without one host-side buffer (VERDICT r3 item
        9). Payloads smaller than one part fall back to a plain PUT (S3
        rejects empty multipart completions)."""
        path = f"/{bucket}/{name}"
        state = {"uid": None, "etags": []}
        buf = bytearray()

        def upload_part(part: bytes) -> None:
            if state["uid"] is None:
                _, data, _ = self._request(
                    "POST", path, query=[("uploads", "")], ok=(200,)
                )
                uid = self._xml(data).find("UploadId")
                if uid is None or not uid.text:
                    raise S3Error(500, b"no UploadId in response")
                state["uid"] = uid.text
            pn = len(state["etags"]) + 1
            _, _, rh = self._request(
                "PUT", path,
                query=[("partNumber", str(pn)), ("uploadId", state["uid"])],
                body=part, ok=(200,),
            )
            state["etags"].append(rh.get("etag", "").strip('"'))

        outer = self

        class _Sink:
            def write(self, b) -> int:
                buf.extend(b)
                while len(buf) >= outer._PART_SIZE:
                    upload_part(bytes(buf[: outer._PART_SIZE]))
                    del buf[: outer._PART_SIZE]
                return len(b)

        try:
            writer(_Sink())
            if state["uid"] is None:
                self.put_object(bucket, name, bytes(buf))
                return
            if buf:
                upload_part(bytes(buf))
            parts = "".join(
                f"<Part><PartNumber>{i + 1}</PartNumber>"
                f'<ETag>"{e}"</ETag></Part>'
                for i, e in enumerate(state["etags"])
            )
            body = (
                "<CompleteMultipartUpload>" + parts +
                "</CompleteMultipartUpload>"
            ).encode()
            self._request(
                "POST", path, query=[("uploadId", state["uid"])],
                body=body, ok=(200,),
            )
        except BaseException:
            if state["uid"] is not None:
                try:
                    self._request(
                        "DELETE", path,
                        query=[("uploadId", state["uid"])], ok=(200, 204),
                    )
                except S3Error:
                    pass  # surfacing the original failure matters more
            raise

    def get_object(self, bucket: str, name: str) -> Optional[bytes]:
        try:
            _, data, _ = self._request("GET", f"/{bucket}/{name}", ok=(200,))
            return data
        except S3Error as e:
            if e.status == 404:
                return None
            raise

    def open_object(self, bucket: str, name: str):
        """Streaming GET: a binary file-like over the response body (None
        if missing). The load-side pair of ``put_object_stream`` — a
        multi-GB checkpoint loads chunk-by-chunk instead of one body."""
        path = f"/{bucket}/{name}"
        amzdate = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%M%SZ"
        )
        payload_hash = hashlib.sha256(b"").hexdigest()
        headers = self._sign("GET", path, [], payload_hash, amzdate)
        url = _uri_encode(path, encode_slash=False)
        cls = (http.client.HTTPSConnection if self.secure
               else http.client.HTTPConnection)
        conn = cls(self.endpoint, timeout=self.timeout)
        try:
            conn.request("GET", url, headers=headers)
            resp = conn.getresponse()
        except BaseException:
            conn.close()
            raise
        if resp.status == 404:
            conn.close()
            return None
        if resp.status != 200:
            body = resp.read()
            conn.close()
            raise S3Error(resp.status, body)
        return _StreamingBody(resp, conn)

    def object_exists(self, bucket: str, name: str) -> bool:
        try:
            self._request("HEAD", f"/{bucket}/{name}", ok=(200,))
            return True
        except S3Error as e:
            if e.status == 404:
                return False
            raise

    def delete_object(self, bucket: str, name: str) -> None:
        # remove every version (LocalObjectStore.delete_object parity)
        for vid in self._version_ids(bucket, name):
            self._request(
                "DELETE", f"/{bucket}/{name}",
                query=[("versionId", vid)], ok=(200, 204),
            )
        self._request("DELETE", f"/{bucket}/{name}", ok=(200, 204))

    def list_objects(self, bucket: str) -> List[str]:
        names: List[str] = []
        token: Optional[str] = None
        while True:
            q: List[Tuple[str, str]] = [("list-type", "2")]
            if token:
                q.append(("continuation-token", token))
            _, data, _ = self._request("GET", f"/{bucket}", query=q, ok=(200,))
            root = self._xml(data)
            for c in root.iter("Contents"):
                key = c.find("Key")
                if key is not None and key.text:
                    names.append(key.text)
            nxt = root.find("NextContinuationToken")
            if nxt is None or not nxt.text:
                break
            token = nxt.text
        return sorted(names)

    # -- version lifecycle (BucketLifeCycleJob parity) --------------------------------
    def _version_ids(self, bucket: str, name: str) -> List[str]:
        """Version ids of ``name`` newest-first (S3 list order), excluding
        the null version marker when versioning was never enabled."""
        try:
            _, data, _ = self._request(
                "GET", f"/{bucket}",
                query=[("versions", ""), ("prefix", name)], ok=(200,),
            )
        except S3Error as e:
            if e.status == 404:
                return []
            raise
        root = self._xml(data)
        out = []
        for v in root.iter("Version"):
            key = v.find("Key")
            vid = v.find("VersionId")
            if key is not None and key.text == name and vid is not None \
                    and vid.text and vid.text != "null":
                out.append(vid.text)
        return out

    def list_versions(self, bucket: str, name: str) -> List[str]:
        """Newest-last, mirroring LocalObjectStore's ascending numbering."""
        return list(reversed(self._version_ids(bucket, name)))

    def cleanup_versions(self, bucket: str, name: str, *, keep: int = 1) -> int:
        """Purge old versions, keeping the newest ``keep``
        (pkg/minio/bucket_handler.go:106-130)."""
        ids = self._version_ids(bucket, name)  # newest first
        drop = ids[keep:] if keep > 0 else ids
        for vid in drop:
            self._request(
                "DELETE", f"/{bucket}/{name}",
                query=[("versionId", vid)], ok=(200, 204),
            )
        return len(drop)
