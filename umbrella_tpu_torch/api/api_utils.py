"""Length-prefixed socket framing, the counterpart of `umbrella_tpu/api/api_utils.py`.

Wire format: a 4-byte big-endian payload length, then the payload, a UTF-8
JSON object. The bytes are the JAX package's, so a client of either package
talks to a server of the other.
"""
import json
import socket


def send_data(conn: socket.socket, data: dict) -> None:
    payload = json.dumps(data).encode("utf-8")
    conn.sendall(len(payload).to_bytes(4, "big"))
    conn.sendall(payload)


def receive_data(conn: socket.socket) -> dict:
    header = b""
    while len(header) < 4:
        chunk = conn.recv(4 - len(header))
        if not chunk:
            raise ConnectionError("Connection lost while receiving header")
        header += chunk
    data_length = int.from_bytes(header, "big")
    data = b""
    while len(data) < data_length:
        chunk = conn.recv(min(65536, data_length - len(data)))
        if not chunk:
            raise ConnectionError("Connection lost while receiving data")
        data += chunk
    return json.loads(data.decode("utf-8"))
