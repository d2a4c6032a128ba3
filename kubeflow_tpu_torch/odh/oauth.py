"""Legacy OAuthClient migration cleanup.

The port's copy of kubeflow_tpu/odh/oauth.py, the port of
notebook_oauth.go: RHOAI 2.x created one cluster-scoped OAuthClient
per notebook; on notebook deletion the matching client (named
`{name}-{namespace}-oauth-client`) is deleted via finalizer
(notebook_oauth.go:67-96).
"""

from __future__ import annotations

from ..kube import ApiServer, KubeObject, NotFoundError


def oauth_client_name(nb: KubeObject) -> str:
    return f"{nb.name}-{nb.namespace}-oauth-client"


def delete_oauth_client(api: ApiServer, nb: KubeObject) -> None:
    """deleteOAuthClient (notebook_oauth.go:67-96); absence is success."""
    try:
        api.delete("OAuthClient", "", oauth_client_name(nb))
    except NotFoundError:
        pass
