"""Dashboard theme layer: the chrome CSS, the functional colors and the
shared JS helpers.

Counterpart of ``.../browser_sections/theme.py``.  The phase and
severity colors carry the same meaning as in the CLI panels; sections do
not re-hue them.  The phase table keeps the JAX keys and colors and
names the compile phase "compile (dynamo)" and the collective phase
"NCCL" (JAX: "XLA", "ICI"); the page's ``COLORS`` and ``SEV`` maps are
generated from the tables.  The shared JS helpers (escaping, formatting,
staleness, sparkline paths, the tooltip) are emitted once.  Every
telemetry-derived string is escaped by ``esc()`` before it is
interpolated: the ingest port is unauthenticated.
"""

from __future__ import annotations

# --- functional palette (shared meaning with the CLI renderers) -----------
# phase key → (ribbon label, color); order = canonical step composition
PHASES = [
    ("input", "IN", "#e74c3c"),
    ("h2d", "H2D", "#e67e22"),
    ("forward", "FWD", "#2d7dd2"),
    ("backward", "BWD", "#2255a4"),
    ("optimizer", "OPT", "#7d3dd2"),
    ("compute", "CMP", "#2d7dd2"),
    ("compile", "compile (dynamo)", "#f1c40f"),
    ("collective", "NCCL", "#16a085"),
    ("checkpoint", "CKPT", "#8e5a2b"),
    ("residual", "RES", "#95a5a6"),
]
SEV = {"info": "#2d7dd2", "warning": "#e67e22", "critical": "#c0392b"}

CSS = """
:root{
  --bg:#0d0f16; --ink:#e9ecf5; --muted:#8d93a8; --accent:#5ad1e6;
  --accent-deep:#2b9ec7; --violet:#9d7bff; --border:rgba(233,236,245,0.10);
  --good:#4ade80; --warn:#e67e22; --crit:#c0392b;
  --mono:"SF Mono",Menlo,Consolas,"Liberation Mono",monospace;
  --sans:system-ui,-apple-system,"Segoe UI",sans-serif;
}
*{box-sizing:border-box}
body{font-family:var(--sans);margin:0;color:var(--ink);min-height:100vh;
  background-color:var(--bg);
  background-image:
    radial-gradient(rgba(233,236,245,0.03) 1px,transparent 1px),
    radial-gradient(900px 480px at 8% -10%,rgba(90,209,230,0.10),transparent 55%),
    radial-gradient(800px 520px at 102% -6%,rgba(157,123,255,0.09),transparent 52%);
  background-size:26px 26px,100% 100%,100% 100%;background-attachment:fixed}
.wrap{max-width:1380px;margin:0 auto;padding:20px 24px;display:flex;
  flex-direction:column;gap:14px}
.grid{display:flex;gap:14px;flex-wrap:wrap;align-items:stretch}
.cell{min-width:300px;display:flex;flex-direction:column}
.card{background:linear-gradient(175deg,rgba(30,34,52,0.82),rgba(22,25,38,0.72));
  border:1px solid var(--border);border-radius:16px;padding:16px 18px;
  box-shadow:inset 0 1px 0 rgba(233,236,245,0.06),0 8px 22px rgba(0,0,0,0.35);
  backdrop-filter:blur(18px);transition:box-shadow .25s,transform .25s;
  min-width:0;width:100%}
.card:hover{transform:translateY(-1px);
  box-shadow:inset 0 1px 0 rgba(233,236,245,0.09),0 14px 30px rgba(0,0,0,0.45)}
@keyframes rise{from{opacity:0;transform:translateY(14px)}to{opacity:1;transform:none}}
.reveal{animation:rise .6s cubic-bezier(.2,.7,.2,1) both}
.d1{animation-delay:.06s}.d2{animation-delay:.12s}.d3{animation-delay:.18s}
.ctitle{font-size:.95rem;font-weight:600;margin:0}
.chead{display:flex;align-items:center;gap:10px;margin-bottom:.55rem}
.chead .sp{flex:1}
.cmeta{font-family:var(--mono);font-size:.72rem;color:var(--muted)}
.muted{color:var(--muted);font-size:.82rem}
.wm{font-weight:700;font-size:1.25rem;letter-spacing:-.01em}
.wm b{color:var(--accent);font-weight:700}
.eyebrow{font-family:var(--mono);font-style:italic;font-size:.72rem;
  color:var(--accent);background:rgba(90,209,230,0.10);
  border:1px solid rgba(90,209,230,0.25);padding:2px 10px;border-radius:999px}
.livedot{width:8px;height:8px;border-radius:999px;background:var(--good);
  animation:pulse 2.4s infinite}
@keyframes pulse{0%{box-shadow:0 0 0 0 rgba(74,222,128,.5)}
  70%{box-shadow:0 0 0 6px rgba(74,222,128,0)}100%{box-shadow:0 0 0 0 rgba(74,222,128,0)}}
table{border-collapse:collapse;width:100%;font-size:.85rem}
th,td{text-align:left;padding:.28rem .5rem;border-bottom:1px solid rgba(233,236,245,0.07)}
th{font-family:var(--mono);font-size:.68rem;letter-spacing:.08em;
  text-transform:uppercase;color:var(--muted);font-weight:600}
td.num,th.num{text-align:right;font-variant-numeric:tabular-nums}
.badge{font-family:var(--mono);font-size:.68rem;border-radius:999px;
  padding:.12rem .5rem;background:rgba(233,236,245,0.08)}
.badge.stale{background:rgba(230,126,34,0.16);color:#ffd27f;
  border:1px solid rgba(230,126,34,0.35)}
.sev-info{border-left:4px solid var(--accent-deep)}
.sev-warning{border-left:4px solid var(--warn)}
.sev-critical{border-left:4px solid var(--crit)}
.finding{margin:.3rem 0;padding:.5rem .65rem;border-radius:10px;
  background:rgba(233,236,245,0.05)}
.meter{background:rgba(233,236,245,0.08);border-radius:3px;width:110px;
  height:11px;display:inline-block;vertical-align:middle;overflow:hidden}
.meter>i{display:block;height:100%;background:var(--accent-deep)}
.meter>i.warn{background:var(--warn)}.meter>i.crit{background:var(--crit)}
pre{white-space:pre-wrap;font-size:.78rem;color:#b8e0c8;margin:0;
  font-family:var(--mono)}
.err{color:#f0a0a0}
svg.chart{width:100%;height:120px;background:rgba(10,12,20,0.55);
  border-radius:8px}
svg.spark{width:100%;height:64px;background:rgba(10,12,20,0.55);
  border-radius:8px}
.legend{display:flex;flex-wrap:wrap;gap:.15rem .8rem}
.legend span{font-family:var(--mono);font-size:.7rem;color:var(--muted);
  cursor:default}
.legend span.toggle{cursor:pointer;user-select:none}
.legend span.off{opacity:.32;text-decoration:line-through}
.legend i{display:inline-block;width:9px;height:9px;border-radius:2px;
  margin-right:.3rem;vertical-align:middle}
/* phase ribbon (the hero signature) */
.ribbon{display:flex;width:100%;height:30px;border-radius:10px;
  overflow:hidden;border:1px solid rgba(233,236,245,0.08);
  box-shadow:inset 0 1px 0 rgba(255,255,255,.08)}
.pseg{height:100%;transition:width .6s cubic-bezier(.4,0,.2,1);display:flex;
  align-items:center;justify-content:center;min-width:0;overflow:hidden}
.seglab{font-family:var(--mono);font-size:.62rem;font-weight:600;
  color:rgba(255,255,255,.95);white-space:nowrap;
  text-shadow:0 1px 1px rgba(0,0,0,.35)}
.verdict{font-size:1.12rem;font-weight:500;letter-spacing:-.005em;margin:.7rem 0 .2rem}
.sevpill{font-family:var(--mono);font-size:.66rem;font-weight:600;
  padding:2px 8px;border-radius:999px;text-transform:uppercase;
  letter-spacing:.06em;color:#fff}
/* KPI tiles */
.kpis{display:flex;gap:9px;flex-wrap:wrap;margin-top:.7rem}
.kpi{position:relative;background:rgba(233,236,245,0.045);
  border:1px solid rgba(233,236,245,0.07);border-radius:11px;
  padding:9px 12px 8px;min-width:104px;flex:1}
.kpi::before{content:'';position:absolute;left:0;top:0;height:100%;width:3px;
  border-radius:3px 0 0 3px;background:var(--acc,var(--accent));opacity:.85}
.klab{font-family:var(--mono);font-size:.62rem;letter-spacing:.09em;
  text-transform:uppercase;color:var(--accent);font-weight:600}
.kval{font-family:var(--mono);font-size:1.1rem;font-weight:600;
  font-variant-numeric:tabular-nums;margin-top:3px;line-height:1.1}
.kunit{font-size:.62em;color:var(--muted);font-weight:500;margin-left:2px}
.heat td{font-family:var(--mono);font-size:.78rem}
#tip{position:fixed;display:none;pointer-events:none;z-index:50;
  background:rgba(16,18,28,0.96);border:1px solid var(--border);
  border-radius:8px;padding:.35rem .55rem;font-family:var(--mono);
  font-size:.72rem;max-width:280px}
"""

# shared JS helpers, emitted once by pages.py before the section scripts;
# the phase and severity colors are the tables above
HELPERS_JS = (
    "\nconst COLORS={" + ",".join(f'{key}:"{color}"' for key, _, color in PHASES) + "};\n"
    "const SEV={" + ",".join(f'{key}:"{color}"' for key, color in SEV.items()) + "};"
) + r"""
// telemetry strings (hostnames, diagnosis text, phase/rank keys) arrive
// from an unauthenticated ingest port — escape EVERY interpolation.
const esc=s=>String(s).replace(/[&<>"']/g,
  c=>({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
const fmtB=n=>{if(n==null||isNaN(n))return"n/a";
  const u=["B","KiB","MiB","GiB","TiB"];let i=0;
  while(n>=1024&&i<u.length-1){n/=1024;i++}return n.toFixed(i?2:0)+" "+u[i]};
const fmtMs=v=>v==null?"n/a":(v<1?(v*1000).toFixed(0)+" µs":
  v<1000?v.toFixed(1)+" ms":(v/1000).toFixed(2)+" s");
const pct=v=>v==null?"—":(v*100).toFixed(1)+"%";
const rankColor=ri=>`hsl(${(ri*67)%360},70%,62%)`;
function badge(el,serverTs,latestTs){
  const e=document.getElementById(el);if(!e)return;
  if(latestTs==null){e.innerHTML='<span class="badge">no data</span>';return}
  const age=serverTs-latestTs;
  e.innerHTML=age>5?`<span class="badge stale">${age.toFixed(0)}s stale</span>`
                   :'<span class="badge">live</span>'}
function meter(frac,warn,crit){
  if(frac==null)return"—";
  const cls=frac>=crit?"crit":frac>=warn?"warn":"";
  const w=Math.min(100,frac*100).toFixed(0);
  return`<span class="meter"><i class="${cls}" style="width:${w}%"></i></span>
    <span class="muted">${(frac*100).toFixed(0)}%</span>`}
function kpiTile(key,label,acc){
  return`<div class="kpi" style="--acc:${esc(acc)}"><span class="klab">${esc(label)}</span>
    <div class="kval" id="kpi-${esc(key)}">—</div></div>`}
function setKpi(key,num,unit){
  const e=document.getElementById("kpi-"+key);if(!e)return;
  e.innerHTML=num==null?"—":`${esc(num)}<span class="kunit">${esc(unit||"")}</span>`}
// shared crosshair tooltip: sections attach via hookTip(svg, fn(frac)->html)
const tip=(()=>{let el=null;return{
  show(html,x,y){if(!el)el=document.getElementById("tip");if(!el)return;
    el.innerHTML=html;el.style.display="block";
    el.style.left=Math.min(x+14,window.innerWidth-300)+"px";
    el.style.top=(y+12)+"px"},
  hide(){if(!el)el=document.getElementById("tip");
    if(el)el.style.display="none"}}})();
function hookTip(svgId,htmlAt){
  const svg=document.getElementById(svgId);if(!svg||svg._tipped)return;
  svg._tipped=true;
  svg.addEventListener("mousemove",ev=>{
    const r=svg.getBoundingClientRect();
    const frac=Math.max(0,Math.min(1,(ev.clientX-r.left)/r.width));
    const html=htmlAt(frac);
    if(html)tip.show(html,ev.clientX,ev.clientY);else tip.hide()});
  svg.addEventListener("mouseleave",()=>tip.hide())}
function sparkPath(series,w,h,max,pad){
  const m=max||Math.max(1,...series);
  return series.map((v,i)=>`${(i/(series.length-1||1))*w},${
    (h-(pad||2))-(v/m)*(h-2*(pad||2))}`).join(" ")}
"""


def head() -> str:
    return f"<style>{CSS}</style>"
