"""Web UI string catalog + locale negotiation.

Counterpart of the reference's web/i18n.py (translation-dict pattern), with
our own key set and a second locale: the UI ships English and Japanese.
Negotiation order: explicit ``?lang=`` query parameter, then the
``Accept-Language`` header, then English.

Templates call ``t(key)`` (injected per-request by the page handlers); the
small set of strings that client-side JS composes dynamically is exported
to ``window.I18N`` via :func:`js_catalog`.
"""

from __future__ import annotations

import json

DEFAULT_LOCALE = "en"

_EN = {
    # chrome
    "app.title": "Totton GPU DSP",
    "app.tagline": "GPU audio upsampling DSP",
    "nav.eq": "EQ",
    "nav.settings": "Settings",
    "nav.opra_sync": "OPRA Sync",
    "footer.license": "OPRA data CC BY-SA 4.0.",
    # status card
    "status.title": "System status",
    "status.daemon": "Daemon",
    "status.running": "running",
    "status.stopped": "stopped",
    "status.phase": "Phase",
    "status.rates": "Rates",
    "status.xruns": "XRUNs",
    "status.uptime": "Uptime",
    "status.reloads": "Reloads",
    "status.level": "Peak / RMS",
    "status.clipped": "Clipped samples",
    "status.refresh": "Refresh",
    # serving plane card (totton-serve multi-stream server)
    "serve.title": "Serving plane",
    "serve.none": "No serving plane running",
    "serve.streams": "Active streams",
    "serve.accepted": "Accepted / finished",
    "serve.steps": "Engine steps",
    "serve.frames_out": "Frames out",
    "serve.swaps": "Live swaps",
    "serve.rss": "Server RSS (MB)",
    "serve.col.slot": "Slot",
    "serve.col.frames": "Frames in / out",
    "serve.col.backlog": "Backlog in / out",
    "serve.col.latency": "Latency p50 / p95 (ms)",
    "serve.col.throttles": "Throttles",
    # DSP controls
    "dsp.title": "DSP controls",
    "dsp.phase_minimum": "Minimum phase",
    "dsp.phase_linear": "Linear phase",
    "dsp.reload": "Reload",
    "dsp.soft_reset": "Soft reset",
    "dsp.restart": "Restart DSP",
    "dsp.restart_confirm": "Restart the DSP process? Audio will drop briefly.",
    # active profile card
    "active.title": "Active EQ profile",
    "active.none": "No EQ profile active",
    "active.source": "Source",
    "active.preamp": "Preamp",
    "active.bands": "Bands",
    "active.deactivate": "Deactivate",
    "active.modern_target": "Modern Target",
    "active.band.type": "Type",
    "active.band.fc": "Fc (Hz)",
    "active.band.gain": "Gain (dB)",
    "active.band.q": "Q",
    "active.band.enabled": "On",
    # upload / import
    "upload.title": "Upload & validate",
    "upload.file_label": "EQ profile (.txt, Equalizer APO format)",
    "upload.validate": "Validate",
    "upload.import": "Import",
    "upload.text_title": "Or paste profile text",
    "upload.name_placeholder": "profile name",
    "upload.content_placeholder": "Preamp: -6 dB\nFilter 1: ON PK Fc 1000 Hz Gain -3 dB Q 1.4",
    "upload.recommended_preamp": "Recommended preamp (headroom)",
    # saved profiles
    "profiles.title": "Saved profiles",
    "profiles.empty": "No profiles yet",
    "profiles.activate": "Activate",
    "profiles.deactivate": "Deactivate",
    "profiles.delete": "Delete",
    "profiles.active_badge": "active",
    # OPRA
    "opra.title": "OPRA headphone database",
    "opra.search_placeholder": "search headphones…",
    "opra.search": "Search",
    "opra.modern_target": "Modern Target (KB5000_7)",
    "opra.no_results": "no results",
    "opra.preview": "Preview",
    "opra.apply": "Apply",
    "opra.attribution": "EQ data: OPRA Project (CC BY-SA 4.0)",
    # settings page
    "settings.title": "Settings",
    "settings.audio": "Audio device",
    "settings.input_device": "Input device",
    "settings.output_device": "Output device",
    "settings.sample_rate": "Sample rate (Hz)",
    "settings.channels": "Channels",
    "settings.format": "PCM format",
    "settings.period": "Period frames",
    "settings.buffer": "Buffer frames",
    "settings.dither": "TPDF dither (s16/s24 output)",
    "settings.filter": "Filter",
    "settings.ratio": "Upsample ratio",
    "settings.phase_type": "Phase type",
    "settings.filter_dir": "Filter directory",
    "settings.eq_enabled": "EQ enabled",
    "settings.save": "Save changes",
    "settings.saved": "Saved.",
    "settings.raw": "Raw config.json",
    # OPRA sync page
    "sync.title": "OPRA database sync",
    "sync.current": "Installed version",
    "sync.none": "none",
    "sync.last_update": "Last update",
    "sync.versions": "Cached versions",
    "sync.check": "Check for updates",
    "sync.update": "Update now",
    "sync.rollback": "Roll back",
    "sync.up_to_date": "Database is up to date.",
    "sync.update_available": "Update available:",
    "sync.in_progress": "Sync in progress…",
}

_JA = {
    "app.title": "Totton GPU DSP",
    "app.tagline": "GPU オーディオアップサンプリングDSP",
    "nav.eq": "EQ",
    "nav.settings": "設定",
    "nav.opra_sync": "OPRA同期",
    "footer.license": "OPRAデータはCC BY-SA 4.0です。",
    "status.title": "システム状態",
    "status.daemon": "デーモン",
    "status.running": "稼働中",
    "status.stopped": "停止",
    "status.phase": "位相",
    "status.rates": "レート",
    "status.xruns": "XRUN数",
    "status.uptime": "稼働時間",
    "status.reloads": "リロード回数",
    "status.level": "ピーク / RMS",
    "status.clipped": "クリップサンプル数",
    "status.refresh": "更新",
    "serve.title": "サービングプレーン",
    "serve.none": "サービングプレーンは稼働していません",
    "serve.streams": "アクティブストリーム数",
    "serve.accepted": "受理 / 完了",
    "serve.steps": "エンジンステップ数",
    "serve.frames_out": "出力フレーム数",
    "serve.swaps": "ライブスワップ数",
    "serve.rss": "サーバー常駐メモリ (MB)",
    "serve.col.slot": "スロット",
    "serve.col.frames": "フレーム 入力 / 出力",
    "serve.col.backlog": "バックログ 入力 / 出力",
    "serve.col.latency": "レイテンシ p50 / p95 (ms)",
    "serve.col.throttles": "スロットル回数",
    "dsp.title": "DSP操作",
    "dsp.phase_minimum": "最小位相",
    "dsp.phase_linear": "直線位相",
    "dsp.reload": "リロード",
    "dsp.soft_reset": "ソフトリセット",
    "dsp.restart": "DSP再起動",
    "dsp.restart_confirm": "DSPを再起動しますか？音声が一時的に途切れます。",
    "active.title": "適用中のEQプロファイル",
    "active.none": "EQプロファイルは未適用です",
    "active.source": "ソース",
    "active.preamp": "プリアンプ",
    "active.bands": "バンド",
    "active.deactivate": "無効化",
    "active.modern_target": "モダンターゲット",
    "active.band.type": "種類",
    "active.band.fc": "Fc (Hz)",
    "active.band.gain": "ゲイン (dB)",
    "active.band.q": "Q",
    "active.band.enabled": "有効",
    "upload.title": "アップロードと検証",
    "upload.file_label": "EQプロファイル (.txt、Equalizer APO形式)",
    "upload.validate": "検証",
    "upload.import": "インポート",
    "upload.text_title": "またはテキストを貼り付け",
    "upload.name_placeholder": "プロファイル名",
    "upload.content_placeholder": "Preamp: -6 dB\nFilter 1: ON PK Fc 1000 Hz Gain -3 dB Q 1.4",
    "upload.recommended_preamp": "推奨プリアンプ（ヘッドルーム）",
    "profiles.title": "保存済みプロファイル",
    "profiles.empty": "プロファイルはまだありません",
    "profiles.activate": "適用",
    "profiles.deactivate": "無効化",
    "profiles.delete": "削除",
    "profiles.active_badge": "適用中",
    "opra.title": "OPRAヘッドホンデータベース",
    "opra.search_placeholder": "ヘッドホンを検索…",
    "opra.search": "検索",
    "opra.modern_target": "モダンターゲット (KB5000_7)",
    "opra.no_results": "該当なし",
    "opra.preview": "プレビュー",
    "opra.apply": "適用",
    "opra.attribution": "EQデータ: OPRAプロジェクト (CC BY-SA 4.0)",
    "settings.title": "設定",
    "settings.audio": "オーディオデバイス",
    "settings.input_device": "入力デバイス",
    "settings.output_device": "出力デバイス",
    "settings.sample_rate": "サンプリングレート (Hz)",
    "settings.channels": "チャンネル数",
    "settings.format": "PCMフォーマット",
    "settings.period": "ピリオドフレーム",
    "settings.buffer": "バッファフレーム",
    "settings.dither": "TPDFディザ（s16/s24出力）",
    "settings.filter": "フィルタ",
    "settings.ratio": "アップサンプリング比",
    "settings.phase_type": "位相タイプ",
    "settings.filter_dir": "フィルタディレクトリ",
    "settings.eq_enabled": "EQ有効",
    "settings.save": "保存",
    "settings.saved": "保存しました。",
    "settings.raw": "config.json（生データ）",
    "sync.title": "OPRAデータベース同期",
    "sync.current": "インストール済みバージョン",
    "sync.none": "なし",
    "sync.last_update": "最終更新",
    "sync.versions": "キャッシュ済みバージョン",
    "sync.check": "更新を確認",
    "sync.update": "今すぐ更新",
    "sync.rollback": "ロールバック",
    "sync.up_to_date": "データベースは最新です。",
    "sync.update_available": "更新があります:",
    "sync.in_progress": "同期中…",
}

TRANSLATIONS: dict[str, dict[str, str]] = {"en": _EN, "ja": _JA}
SUPPORTED_LOCALES = tuple(TRANSLATIONS)

#: Keys client-side JS composes dynamically (subset exported per page).
_JS_KEYS = (
    "status.running", "status.stopped", "profiles.empty",
    "profiles.activate", "profiles.deactivate", "profiles.delete",
    "profiles.active_badge", "opra.no_results", "opra.preview", "opra.apply",
    "active.none", "dsp.restart_confirm", "sync.up_to_date",
    "sync.update_available", "sync.in_progress", "sync.none",
    "upload.recommended_preamp", "serve.none",
    "serve.col.slot", "serve.col.frames", "serve.col.backlog",
    "serve.col.latency", "serve.col.throttles",
)


def negotiate_locale(request) -> str:
    """``?lang=`` > Accept-Language > default. aiohttp Request or None."""
    if request is None:
        return DEFAULT_LOCALE
    lang = request.query.get("lang", "")
    if lang in TRANSLATIONS:
        return lang
    accept = request.headers.get("Accept-Language", "")
    for part in accept.split(","):
        code = part.split(";")[0].strip().lower()
        primary = code.split("-")[0]
        if code in TRANSLATIONS:
            return code
        if primary in TRANSLATIONS:
            return primary
    return DEFAULT_LOCALE


def translator(locale: str):
    """t(key) with en fallback, then the key itself (visible, greppable)."""
    table = TRANSLATIONS.get(locale, _EN)

    def t(key: str) -> str:
        return table.get(key) or _EN.get(key) or key

    return t


def js_catalog(locale: str) -> str:
    """JSON object literal of the JS-needed strings for ``window.I18N``."""
    t = translator(locale)
    return json.dumps({k: t(k) for k in _JS_KEYS}, ensure_ascii=False)
