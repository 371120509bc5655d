"""CMUdict-class American English pronunciation table for the builtin G2P.

The reference gets full-dictionary pronunciations from the espeak C library
(reference: data/text/tokenizer.py:66-74). This module closes most of that
gap for hosts without espeak: a few thousand frequent English lemmas
authored in ARPAbet (the public-domain CMUdict conventions) and mapped to
espeak-ng-style en-us IPA at import time, plus a light morphology layer
(plural/possessive -s, -ed, -ing, -ly, -er/-est, n't) that derives inflected
forms from the lemma table with the standard voicing-assimilation rules —
so effective token coverage is far higher than the raw entry count.

Layering (see g2p.py): curated irregulars -> this table -> letter-to-sound
rules. Output is restricted to ``symbols.all_phonemes`` so it always
tokenizes; a startup assertion enforces that.

ARPAbet -> espeak-like IPA conventions (matched to the frozen fixture
tests/fixtures/espeak_en_us_ipa.tsv):

- stress digit 1 -> ``ˈ`` and 2 -> ``ˌ`` placed immediately before the
  vowel symbol (espeak style: ``wˈɜːd``), digit 0 -> unmarked;
- en-us rhotics: ``R`` -> ``ɹ``, ``ER0`` -> ``ɚ``, ``ER1/2`` -> ``ɜː``;
- length marks on the long monophthongs (``iː uː ɑː ɔː ɜː``);
- intervocalic flapping: ``T`` between a vowel/r-colored phone and an
  unstressed vowel -> ``ɾ`` (``wˈɔːɾɚ``), also applied when a vowel-initial
  suffix attaches after a final ``t`` (``created`` -> ``kɹiːˈeɪɾɪd``);
- word-initial unstressed ``AH0`` -> ``ɐ`` (``about`` -> ``ɐbˈaʊt``),
  elsewhere ``ə``; word-final unstressed ``IY0`` -> ``i`` (``city`` ->
  ``sˈɪɾi``).
"""
from typing import Dict, List, Optional, Tuple

_VOWELS = {
    'AA': 'ɑː', 'AE': 'æ', 'AO': 'ɔː', 'AW': 'aʊ', 'AY': 'aɪ',
    'EH': 'ɛ', 'EY': 'eɪ', 'IH': 'ɪ', 'OW': 'oʊ', 'OY': 'ɔɪ',
    'UH': 'ʊ', 'UW': 'uː',
    # AH / ER / IY are stress- and position-dependent, handled in code
    'AH': 'ʌ', 'ER': 'ɜː', 'IY': 'iː',
}

_CONSONANTS = {
    'B': 'b', 'CH': 'tʃ', 'D': 'd', 'DH': 'ð', 'F': 'f', 'G': 'ɡ',
    'HH': 'h', 'JH': 'dʒ', 'K': 'k', 'L': 'l', 'M': 'm', 'N': 'n',
    'NG': 'ŋ', 'P': 'p', 'R': 'ɹ', 'S': 's', 'SH': 'ʃ', 'T': 't',
    'TH': 'θ', 'V': 'v', 'W': 'w', 'Y': 'j', 'Z': 'z', 'ZH': 'ʒ',
}

_FLAP_BEFORE = set(_VOWELS) | {'R'}   # phones T can flap after


def _split(phone: str) -> Tuple[str, Optional[int]]:
    if phone and phone[-1].isdigit():
        return phone[:-1], int(phone[-1])
    return phone, None


def arpa_to_ipa(phones: List[str]) -> str:
    """Map one ARPAbet pronunciation (with stress digits) to en-us IPA."""
    out: List[str] = []
    n = len(phones)
    for i, phone in enumerate(phones):
        base, stress = _split(phone)
        if base in _VOWELS:
            if stress == 1:
                out.append('ˈ')
            elif stress == 2:
                out.append('ˌ')
            if base == 'AH' and stress == 0:
                out.append('ɐ' if i == 0 else 'ə')
            elif (base == 'ER' and stress == 0 and i + 1 < n
                  and _split(phones[i + 1])[0] in _VOWELS
                  and _split(phones[i + 1])[1] == 0):
                # espeak elides unstressed ER before another unstressed
                # vowel: conference→kˈɑːnfɹəns, general→dʒˈɛnɹəl,
                # every→ˈɛvɹi (kept as ɚ before stressed vowels/consonants)
                out.append('ɹ')
            elif base == 'ER' and stress == 0:
                out.append('ɚ')
            elif base == 'IY' and stress == 0 and i == n - 1:
                out.append('i')
            elif (base == 'AO' and i + 1 < n
                  and _split(phones[i + 1])[0] in ('NG', 'G')):
                # espeak en-us uses the LOT vowel before ŋ/ɡ: long→lˈɑːŋ,
                # wrong→ɹˈɑːŋ, dog→dˈɑːɡ (CMUdict writes AO for all;
                # fixture-attested)
                out.append('ɑː')
            else:
                out.append(_VOWELS[base])
        elif base == 'T' and 0 < i < n - 1:
            prev, _ = _split(phones[i - 1])
            nxt, nxt_stress = _split(phones[i + 1])
            if prev in _FLAP_BEFORE and nxt in _VOWELS and nxt_stress == 0:
                out.append('ɾ')
            else:
                out.append('t')
        else:
            out.append(_CONSONANTS[base])
    return ''.join(out)


# Lemma table: ``word  ARPABET...`` per line (CMUdict conventions).
# Inflected forms (plural -s, past -ed, -ing, adverbial -ly, -er/-est,
# possessive 's, n't) are DERIVED by lookup(); only store them explicitly
# when irregular. '#' comments and blank lines allowed.
_ARPA_TABLE = r"""
nation N EY1 SH AH0 N
rather R AE1 DH ER0
new N UW1
dead D EH1 D
shall SH AE1 L
conceive K AH0 N S IY1 V
liberty L IH1 B ER0 T IY0
man M AE1 N
men M EH1 N
war W AO1 R
long L AO1 NG
met M EH1 T
meet M IY1 T
field F IY1 L D
dedicate D EH1 D AH0 K EY2 T
devotion D IH0 V OW1 SH AH0 N
unite Y UW0 N AY1 T
state S T EY1 T
establish IH0 S T AE1 B L IH0 SH
nice N AY1 S
test T EH1 S T
score S K AO1 R
seven S EH1 V AH0 N
year Y IH1 R
ago AH0 G OW1
father F AA1 DH ER0
bring B R IH1 NG
brought B R AO1 T
forth F AO1 R TH
continent K AA1 N T AH0 N AH0 N T
proposition P R AA2 P AH0 Z IH1 SH AH0 N
create K R IY0 EY1 T
equal IY1 K W AH0 L
engage IH0 N G EY1 JH
civil S IH1 V AH0 L
whether W EH1 DH ER0
endure IH0 N D UH1 R
battle B AE1 T AH0 L
portion P AO1 R SH AH0 N
final F AY1 N AH0 L
rest R EH1 S T
place P L EY1 S
those DH OW1 Z
might M AY1 T
altogether AO2 L T AH0 G EH1 DH ER0
fit F IH1 T
proper P R AA1 P ER0
large L AA1 R JH
sense S EH1 N S
consecrate K AA1 N S AH0 K R EY2 T
hallow HH AE1 L OW0
ground G R AW1 N D
brave B R EY1 V
struggle S T R AH1 G AH0 L
poor P UH1 R
power P AW1 ER0
add AE1 D
detract D IH0 T R AE1 K T
little L IH1 T AH0 L
note N OW1 T
nor N AO1 R
remember R IH0 M EH1 M B ER0
did D IH1 D
finish F IH1 N IH0 SH
unfinished AH0 N F IH1 N IH0 SH T
work W ER1 K
fight F AY1 T
fought F AO1 T
thus DH AH1 S
noble N OW1 B AH0 L
nobly N OW1 B L IY0
advance AH0 D V AE1 N S
task T AE1 S K
remain R IH0 M EY1 N
honor AA1 N ER0
take T EY1 K
took T UH1 K
taken T EY1 K AH0 N
increase IH0 N K R IY1 S
cause K AO1 Z
last L AE1 S T
high HH AY1
highly HH AY1 L IY0
resolve R IH0 Z AA1 L V
die D AY1
vain V EY1 N
under AH1 N D ER0
god G AA1 D
birth B ER1 TH
freedom F R IY1 D AH0 M
government G AH1 V ER0 N M AH0 N T
perish P EH1 R IH0 SH
earth ER1 TH
order AO1 R D ER0
form F AO1 R M
perfect P ER1 F IH0 K T
union Y UW1 N Y AH0 N
justice JH AH1 S T IH0 S
insure IH0 N SH UH1 R
domestic D AH0 M EH1 S T IH0 K
tranquility T R AE0 NG K W IH1 L AH0 T IY0
provide P R AH0 V AY1 D
common K AA1 M AH0 N
defence D IH0 F EH1 N S
defense D IH0 F EH1 N S
promote P R AH0 M OW1 T
general JH EH1 N ER0 AH0 L
welfare W EH1 L F EH2 R
secure S IH0 K Y UH1 R
blessing B L EH1 S IH0 NG
bless B L EH1 S
ourselves AW2 ER0 S EH1 L V Z
posterity P AA0 S T EH1 R AH0 T IY0
ordain AO0 R D EY1 N
constitution K AA2 N S T AH0 T UW1 SH AH0 N
america AH0 M EH1 R IH0 K AH0
president P R EH1 Z IH0 D AH0 N T
trump T R AH1 M P
leader L IY1 D ER0
group G R UW1 P
twenty T W EH1 N T IY0
conference K AA1 N F ER0 AH0 N S
scientist S AY1 AH0 N T IH2 S T
cern S ER1 N
laboratory L AE1 B R AH0 T AO2 R IY0
discover D IH0 S K AH1 V ER0
particle P AA1 R T IH0 K AH0 L
way W EY1
acute AH0 K Y UW1 T
emotion IH0 M OW1 SH AH0 N
emotional IH0 M OW1 SH AH0 N AH0 L
intelligence IH0 N T EH1 L IH0 JH AH0 N S
style S T AY1 L
senate S EH1 N AH0 T
bill B IH1 L
repeal R IH0 P IY1 L
replace R IH0 P L EY1 S
afford AH0 F AO1 R D
affordable AH0 F AO1 R D AH0 B AH0 L
care K EH1 R
act AE1 K T
imperil IH0 M P EH1 R AH0 L
peter P IY1 T ER0
piper P AY1 P ER0
pick P IH1 K
peck P EH1 K
pickle P IH1 K AH0 L
pepper P EH1 P ER0
definite D EH1 F AH0 N AH0 T
definitely D EH1 F IH0 N AH0 T L IY0
try T R AY1
sound S AW1 N D
normal N AO1 R M AH0 L
"""

# General high-frequency vocabulary (extended in chunks below).
_ARPA_TABLE += r"""
time T AY1 M
person P ER1 S AH0 N
thing TH IH1 NG
child CH AY1 L D
children CH IH1 L D R AH0 N
life L AY1 F
hand HH AE1 N D
part P AA1 R T
eye AY1
week W IY1 K
case K EY1 S
point P OY1 N T
fact F AE1 K T
house HH AW1 S
home HH OW1 M
room R UW1 M
mother M AH1 DH ER0
area EH1 R IY0 AH0
money M AH1 N IY0
story S T AO1 R IY0
month M AH1 N TH
lot L AA1 T
right R AY1 T
study S T AH1 D IY0
book B UH1 K
job JH AA1 B
word W ER1 D
business B IH1 Z N AH0 S
issue IH1 SH UW0
side S AY1 D
kind K AY1 N D
head HH EH1 D
far F AA1 R
black B L AE1 K
both B OW1 TH
white W AY1 T
long L AO1 NG
night N AY1 T
service S ER1 V AH0 S
down D AW1 N
friend F R EH1 N D
away AH0 W EY1
law L AO1
name N EY1 M
company K AH1 M P AH0 N IY0
number N AH1 M B ER0
system S IH1 S T AH0 M
program P R OW1 G R AE2 M
question K W EH1 S CH AH0 N
during D UH1 R IH0 NG
play P L EY1
run R AH1 N
small S M AO1 L
big B IH1 G
group G R UW1 P
begin B IH0 G IH1 N
began B IH0 G AE1 N
begun B IH0 G AH1 N
seem S IY1 M
country K AH1 N T R IY0
help HH EH1 L P
talk T AO1 K
turn T ER1 N
start S T AA1 R T
show SH OW1
hear HH IY1 R
heard HH ER1 D
let L EH1 T
thought TH AO1 T
think TH IH1 NG K
hold HH OW1 L D
held HH EH1 L D
keep K IY1 P
kept K EH1 P T
family F AE1 M AH0 L IY0
feel F IY1 L
felt F EH1 L T
stand S T AE1 N D
stood S T UH1 D
leave L IY1 V
left L EH1 F T
mean M IY1 N
meant M EH1 N T
old OW1 L D
same S EY1 M
tell T EH1 L
told T OW1 L D
boy B OY1
follow F AA1 L OW0
came K EY1 M
want W AA1 N T
school S K UW1 L
country K AH1 N T R IY0
never N EH1 V ER0
own OW1 N
need N IY1 D
become B IH0 K AH1 M
became B IH0 K EY1 M
call K AO1 L
state S T EY1 T
world W ER1 L D
still S T IH1 L
see S IY1
saw S AO1
seen S IY1 N
between B IH0 T W IY1 N
city S IH1 T IY0
tree T R IY1
cross K R AO1 S
since S IH1 N S
hard HH AA1 R D
against AH0 G EH1 N S T
pattern P AE1 T ER0 N
slow S L OW1
center S EH1 N T ER0
farm F AA1 R M
top T AA1 P
reach R IY1 CH
fast F AE1 S T
sing S IH1 NG
listen L IH1 S AH0 N
six S IH1 K S
table T EY1 B AH0 L
travel T R AE1 V AH0 L
less L EH1 S
morning M AO1 R N IH0 NG
ten T EH1 N
simple S IH1 M P AH0 L
several S EH1 V ER0 AH0 L
toward T AH0 W AO1 R D
towards T AH0 W AO1 R D Z
against AH0 G EH1 N S T
early ER1 L IY0
hundred HH AH1 N D R AH0 D
thousand TH AW1 Z AH0 N D
million M IH1 L Y AH0 N
remember R IH0 M EH1 M B ER0
course K AO1 R S
door D AO1 R
ship SH IH1 P
across AH0 K R AO1 S
today T AH0 D EY1
however HH AW2 EH1 V ER0
sure SH UH1 R
knew N UW1
known N OW1 N
island AY1 L AH0 N D
week W IY1 K
less L EH1 S
machine M AH0 SH IY1 N
base B EY1 S
ago AH0 G OW1
stay S T EY1
plane P L EY1 N
plan P L AE1 N
music M Y UW1 Z IH0 K
color K AH1 L ER0
war W AO1 R
fine F AY1 N
round R AW1 N D
mark M AA1 R K
dog D AO1 G
cat K AE1 T
bird B ER1 D
horse HH AO1 R S
problem P R AA1 B L AH0 M
complete K AH0 M P L IY1 T
since S IH1 N S
piece P IY1 S
told T OW1 L D
usually Y UW1 ZH AH0 W AH0 L IY0
usual Y UW1 ZH AH0 W AH0 L
friend F R EH1 N D
easy IY1 Z IY0
black B L AE1 K
product P R AA1 D AH0 K T
happen HH AE1 P AH0 N
whole HH OW1 L
measure M EH1 ZH ER0
remember R IH0 M EH1 M B ER0
hot HH AA1 T
cold K OW1 L D
warm W AO1 R M
cool K UW1 L
"""

_ARPA_TABLE += r"""
ability AH0 B IH1 L AH0 T IY0
able EY1 B AH0 L
above AH0 B AH1 V
accept AE0 K S EH1 P T
access AE1 K S EH2 S
accident AE1 K S AH0 D AH0 N T
account AH0 K AW1 N T
action AE1 K SH AH0 N
active AE1 K T IH0 V
activity AE0 K T IH1 V AH0 T IY0
actor AE1 K T ER0
actual AE1 K CH UW0 AH0 L
actually AE1 K CH UW0 AH0 L IY0
address AH0 D R EH1 S
administration AH0 D M IH2 N AH0 S T R EY1 SH AH0 N
admit AH0 D M IH1 T
adult AH0 D AH1 L T
affect AH0 F EH1 K T
afraid AH0 F R EY1 D
africa AE1 F R IH0 K AH0
afternoon AE2 F T ER0 N UW1 N
age EY1 JH
agency EY1 JH AH0 N S IY0
agent EY1 JH AH0 N T
agree AH0 G R IY1
agreement AH0 G R IY1 M AH0 N T
ahead AH0 HH EH1 D
air EH1 R
allow AH0 L AW1
almost AO1 L M OW2 S T
alone AH0 L OW1 N
along AH0 L AO1 NG
already AO0 L R EH1 D IY0
alright AO0 L R AY1 T
although AO0 L DH OW1
always AO1 L W EY2 Z
amount AH0 M AW1 N T
analysis AH0 N AE1 L AH0 S AH0 S
animal AE1 N AH0 M AH0 L
announce AH0 N AW1 N S
annual AE1 N Y UW0 AH0 L
another AH0 N AH1 DH ER0
anyone EH1 N IY0 W AH2 N
anything EH1 N IY0 TH IH2 NG
anyway EH1 N IY0 W EY2
anywhere EH1 N IY0 W EH2 R
apart AH0 P AA1 R T
apartment AH0 P AA1 R T M AH0 N T
appear AH0 P IH1 R
apple AE1 P AH0 L
apply AH0 P L AY1
appropriate AH0 P R OW1 P R IY0 AH0 T
approve AH0 P R UW1 V
april EY1 P R AH0 L
argue AA1 R G Y UW0
argument AA1 R G Y AH0 M AH0 N T
arm AA1 R M
army AA1 R M IY0
around AH0 R AW1 N D
arrive AH0 R AY1 V
art AA1 R T
article AA1 R T IH0 K AH0 L
artist AA1 R T AH0 S T
ask AE1 S K
asleep AH0 S L IY1 P
attack AH0 T AE1 K
attempt AH0 T EH1 M P T
attend AH0 T EH1 N D
attention AH0 T EH1 N SH AH0 N
attorney AH0 T ER1 N IY0
audience AA1 D IY0 AH0 N S
august AA1 G AH0 S T
author AO1 TH ER0
authority AH0 TH AO1 R AH0 T IY0
available AH0 V EY1 L AH0 B AH0 L
avoid AH0 V OY1 D
award AH0 W AO1 R D
aware AH0 W EH1 R
baby B EY1 B IY0
back B AE1 K
bad B AE1 D
bag B AE1 G
balance B AE1 L AH0 N S
ball B AO1 L
bank B AE1 NG K
bar B AA1 R
barely B EH1 R L IY0
base B EY1 S
basic B EY1 S IH0 K
basis B EY1 S AH0 S
beach B IY1 CH
bear B EH1 R
beat B IY1 T
beauty B Y UW1 T IY0
bed B EH1 D
bedroom B EH1 D R UW2 M
beer B IH1 R
behavior B IH0 HH EY1 V Y ER0
behind B IH0 HH AY1 N D
believe B IH0 L IY1 V
belong B IH0 L AO1 NG
below B IH0 L OW1
benefit B EH1 N AH0 F IH0 T
best B EH1 S T
better B EH1 T ER0
beyond B IH0 AA1 N D
billion B IH1 L Y AH0 N
bit B IH1 T
blood B L AH1 D
blue B L UW1
board B AO1 R D
boat B OW1 T
body B AA1 D IY0
bone B OW1 N
border B AO1 R D ER0
born B AO1 R N
bottle B AA1 T AH0 L
bottom B AA1 T AH0 M
box B AA1 K S
brain B R EY1 N
branch B R AE1 N CH
bread B R EH1 D
break B R EY1 K
broke B R OW1 K
broken B R OW1 K AH0 N
breakfast B R EH1 K F AH0 S T
breath B R EH1 TH
breathe B R IY1 DH
bridge B R IH1 JH
brief B R IY1 F
bright B R AY1 T
brother B R AH1 DH ER0
brown B R AW1 N
budget B AH1 JH IH0 T
build B IH1 L D
built B IH1 L T
building B IH1 L D IH0 NG
burn B ER1 N
bus B AH1 S
busy B IH1 Z IY0
buy B AY1
bought B AO1 T
camera K AE1 M ER0 AH0
campaign K AE0 M P EY1 N
cancer K AE1 N S ER0
candidate K AE1 N D AH0 D EY2 T
capital K AE1 P AH0 T AH0 L
captain K AE1 P T AH0 N
car K AA1 R
card K AA1 R D
career K ER0 IH1 R
careful K EH1 R F AH0 L
carry K AE1 R IY0
catch K AE1 CH
caught K AO1 T
cell S EH1 L
central S EH1 N T R AH0 L
century S EH1 N CH ER0 IY0
certain S ER1 T AH0 N
certainly S ER1 T AH0 N L IY0
chair CH EH1 R
challenge CH AE1 L AH0 N JH
chance CH AE1 N S
change CH EY1 N JH
character K EH1 R IH0 K T ER0
charge CH AA1 R JH
check CH EH1 K
chest CH EH1 S T
chicken CH IH1 K AH0 N
chief CH IY1 F
choice CH OY1 S
choose CH UW1 Z
chose CH OW1 Z
chosen CH OW1 Z AH0 N
church CH ER1 CH
circle S ER1 K AH0 L
citizen S IH1 T AH0 Z AH0 N
claim K L EY1 M
class K L AE1 S
clean K L IY1 N
clear K L IH1 R
clearly K L IH1 R L IY0
climb K L AY1 M
clock K L AA1 K
close K L OW1 S
closed K L OW1 Z D
clothes K L OW1 DH Z
cloud K L AW1 D
club K L AH1 B
coach K OW1 CH
coast K OW1 S T
coffee K AA1 F IY0
collect K AH0 L EH1 K T
collection K AH0 L EH1 K SH AH0 N
college K AA1 L IH0 JH
commercial K AH0 M ER1 SH AH0 L
commission K AH0 M IH1 SH AH0 N
committee K AH0 M IH1 T IY0
community K AH0 M Y UW1 N AH0 T IY0
compare K AH0 M P EH1 R
comparison K AH0 M P EH1 R AH0 S AH0 N
compete K AH0 M P IY1 T
competition K AA2 M P AH0 T IH1 SH AH0 N
computer K AH0 M P Y UW1 T ER0
concern K AH0 N S ER1 N
condition K AH0 N D IH1 SH AH0 N
conduct K AH0 N D AH1 K T
confidence K AA1 N F AH0 D AH0 N S
confirm K AH0 N F ER1 M
congress K AA1 NG G R AH0 S
connect K AH0 N EH1 K T
connection K AH0 N EH1 K SH AH0 N
consider K AH0 N S IH1 D ER0
consumer K AH0 N S UW1 M ER0
contain K AH0 N T EY1 N
continue K AH0 N T IH1 N Y UW0
contract K AA1 N T R AE2 K T
control K AH0 N T R OW1 L
conversation K AA2 N V ER0 S EY1 SH AH0 N
cook K UH1 K
copy K AA1 P IY0
corner K AO1 R N ER0
correct K ER0 EH1 K T
cost K AO1 S T
count K AW1 N T
couple K AH1 P AH0 L
courage K ER1 IH0 JH
court K AO1 R T
cover K AH1 V ER0
crazy K R EY1 Z IY0
cream K R IY1 M
crime K R AY1 M
crisis K R AY1 S AH0 S
critical K R IH1 T IH0 K AH0 L
crowd K R AW1 D
cultural K AH1 L CH ER0 AH0 L
culture K AH1 L CH ER0
cup K AH1 P
current K ER1 AH0 N T
currently K ER1 AH0 N T L IY0
customer K AH1 S T AH0 M ER0
cut K AH1 T
dance D AE1 N S
danger D EY1 N JH ER0
dangerous D EY1 N JH ER0 AH0 S
dark D AA1 R K
data D EY1 T AH0
date D EY1 T
daughter D AO1 T ER0
deal D IY1 L
dealt D EH1 L T
death D EH1 TH
debate D AH0 B EY1 T
decade D EH1 K EY0 D
december D IH0 S EH1 M B ER0
decide D IH0 S AY1 D
decision D IH0 S IH1 ZH AH0 N
deep D IY1 P
degree D IH0 G R IY1
democracy D IH0 M AA1 K R AH0 S IY0
democratic D EH2 M AH0 K R AE1 T IH0 K
describe D IH0 S K R AY1 B
description D IH0 S K R IH1 P SH AH0 N
design D IH0 Z AY1 N
despite D IH0 S P AY1 T
detail D IH0 T EY1 L
determine D IH0 T ER1 M AH0 N
develop D IH0 V EH1 L AH0 P
development D IH0 V EH1 L AH0 P M AH0 N T
device D IH0 V AY1 S
dinner D IH1 N ER0
direct D ER0 EH1 K T
direction D ER0 EH1 K SH AH0 N
directly D ER0 EH1 K T L IY0
director D ER0 EH1 K T ER0
discuss D IH0 S K AH1 S
discussion D IH0 S K AH1 SH AH0 N
disease D IH0 Z IY1 Z
distance D IH1 S T AH0 N S
district D IH1 S T R IH0 K T
divide D IH0 V AY1 D
doctor D AA1 K T ER0
dollar D AA1 L ER0
double D AH1 B AH0 L
doubt D AW1 T
dozen D AH1 Z AH0 N
draw D R AO1
drew D R UW1
drawn D R AO1 N
dream D R IY1 M
dress D R EH1 S
drink D R IH1 NG K
drank D R AE1 NG K
drive D R AY1 V
drove D R OW1 V
driven D R IH1 V AH0 N
driver D R AY1 V ER0
drop D R AA1 P
drug D R AH1 G
dry D R AY1
due D UW1
dust D AH1 S T
duty D UW1 T IY0
ear IH1 R
east IY1 S T
eat IY1 T
ate EY1 T
eaten IY1 T AH0 N
economic EH2 K AH0 N AA1 M IH0 K
economy IH0 K AA1 N AH0 M IY0
edge EH1 JH
education EH2 JH AH0 K EY1 SH AH0 N
effect IH0 F EH1 K T
effective IH0 F EH1 K T IH0 V
effort EH1 F ER0 T
egg EH1 G
eight EY1 T
either IY1 DH ER0
election IH0 L EH1 K SH AH0 N
electric IH0 L EH1 K T R IH0 K
eleven IH0 L EH1 V AH0 N
else EH1 L S
emergency IH0 M ER1 JH AH0 N S IY0
employee EH0 M P L OY1 IY0
empty EH1 M P T IY0
end EH1 N D
enemy EH1 N AH0 M IY0
energy EH1 N ER0 JH IY0
engine EH1 N JH AH0 N
english IH1 NG G L IH0 SH
enjoy EH0 N JH OY1
enter EH1 N T ER0
entire EH0 N T AY1 R
environment IH0 N V AY1 R AH0 N M AH0 N T
especially AH0 S P EH1 SH L IY0
establish IH0 S T AE1 B L IH0 SH
evening IY1 V N IH0 NG
event IH0 V EH1 N T
ever EH1 V ER0
every EH1 V ER0 IY0
everybody EH1 V R IY0 B AH2 D IY0
everyone EH1 V R IY0 W AH2 N
everything EH1 V R IY0 TH IH2 NG
evidence EH1 V AH0 D AH0 N S
exactly IH0 G Z AE1 K T L IY0
example IH0 G Z AE1 M P AH0 L
excellent EH1 K S AH0 L AH0 N T
except IH0 K S EH1 P T
exchange IH0 K S CH EY1 N JH
exciting IH0 K S AY1 T IH0 NG
executive IH0 G Z EH1 K Y AH0 T IH0 V
exercise EH1 K S ER0 S AY2 Z
exist IH0 G Z IH1 S T
expect IH0 K S P EH1 K T
experience IH0 K S P IH1 R IY0 AH0 N S
expert EH1 K S P ER2 T
explain IH0 K S P L EY1 N
express IH0 K S P R EH1 S
extra EH1 K S T R AH0
face F EY1 S
factor F AE1 K T ER0
fail F EY1 L
fair F EH1 R
fall F AO1 L
fell F EH1 L
fallen F AO1 L AH0 N
false F AO1 L S
famous F EY1 M AH0 S
fan F AE1 N
fear F IH1 R
february F EH1 B Y AH0 W EH2 R IY0
federal F EH1 D ER0 AH0 L
feed F IY1 D
fed F EH1 D
feeling F IY1 L IH0 NG
few F Y UW1
figure F IH1 G Y ER0
fill F IH1 L
film F IH1 L M
finally F AY1 N AH0 L IY0
financial F AH0 N AE1 N SH AH0 L
find F AY1 N D
found F AW1 N D
finger F IH1 NG G ER0
fire F AY1 ER0
firm F ER1 M
fish F IH1 SH
five F AY1 V
flag F L AE1 G
flight F L AY1 T
floor F L AO1 R
flow F L OW1
flower F L AW1 ER0
fly F L AY1
flew F L UW1
flown F L OW1 N
focus F OW1 K AH0 S
food F UW1 D
force F AO1 R S
foreign F AO1 R AH0 N
forest F AO1 R AH0 S T
forever F ER0 EH1 V ER0
formal F AO1 R M AH0 L
former F AO1 R M ER0
forward F AO1 R W ER0 D
frame F R EY1 M
free F R IY1
fresh F R EH1 SH
friday F R AY1 D EY2
front F R AH1 N T
fruit F R UW1 T
fuel F Y UW1 AH0 L
fun F AH1 N
function F AH1 NG K SH AH0 N
fund F AH1 N D
future F Y UW1 CH ER0
game G EY1 M
garden G AA1 R D AH0 N
gas G AE1 S
gather G AE1 DH ER0
gentleman JH EH1 N T AH0 L M AH0 N
glad G L AE1 D
glass G L AE1 S
global G L OW1 B AH0 L
goal G OW1 L
gold G OW1 L D
gone G AO1 N
grade G R EY1 D
grand G R AE1 N D
grass G R AE1 S
gray G R EY1
green G R IY1 N
grew G R UW1
grow G R OW1
grown G R OW1 N
growth G R OW1 TH
guard G AA1 R D
guess G EH1 S
guest G EH1 S T
gun G AH1 N
guy G AY1
hair HH EH1 R
hang HH AE1 NG
hung HH AH1 NG
happy HH AE1 P IY0
hate HH EY1 T
health HH EH1 L TH
healthy HH EH1 L TH IY0
heat HH IY1 T
heavy HH EH1 V IY0
herself HH ER0 S EH1 L F
hide HH AY1 D
hid HH IH1 D
hidden HH IH1 D AH0 N
history HH IH1 S T ER0 IY0
hit HH IH1 T
hope HH OW1 P
hospital HH AA1 S P IH0 T AH0 L
hotel HH OW0 T EH1 L
huge HH Y UW1 JH
husband HH AH1 Z B AH0 N D
idea AY0 D IY1 AH0
identify AY0 D EH1 N T AH0 F AY2
image IH1 M AH0 JH
imagine IH0 M AE1 JH AH0 N
impact IH1 M P AE0 K T
important IH0 M P AO1 R T AH0 N T
improve IH0 M P R UW1 V
include IH0 N K L UW1 D
including IH0 N K L UW1 D IH0 NG
income IH1 N K AH2 M
indeed IH0 N D IY1 D
indicate IH1 N D AH0 K EY2 T
individual IH2 N D AH0 V IH1 JH AH0 W AH0 L
industry IH1 N D AH0 S T R IY0
information IH2 N F ER0 M EY1 SH AH0 N
inside IH0 N S AY1 D
instead IH0 N S T EH1 D
institution IH2 N S T IH0 T UW1 SH AH0 N
interest IH1 N T R AH0 S T
interesting IH1 N T R AH0 S T IH0 NG
international IH2 N T ER0 N AE1 SH AH0 N AH0 L
internet IH1 N T ER0 N EH2 T
interview IH1 N T ER0 V Y UW2
investment IH0 N V EH1 S T M AH0 N T
involve IH0 N V AA1 L V
iron AY1 ER0 N
item AY1 T AH0 M
itself IH0 T S EH1 L F
january JH AE1 N Y UW0 EH2 R IY0
joy JH OY1
judge JH AH1 JH
july JH UH0 L AY1
jump JH AH1 M P
june JH UW1 N
just JH AH1 S T
key K IY1
kick K IH1 K
kid K IH1 D
kill K IH1 L
king K IH1 NG
kitchen K IH1 CH AH0 N
knee N IY1
knife N AY1 F
knock N AA1 K
knowledge N AA1 L IH0 JH
lady L EY1 D IY0
lake L EY1 K
land L AE1 N D
language L AE1 NG G W AH0 JH
late L EY1 T
later L EY1 T ER0
laugh L AE1 F
lay L EY1
lead L IY1 D
led L EH1 D
learn L ER1 N
learned L ER1 N D
least L IY1 S T
leg L EH1 G
legal L IY1 G AH0 L
lesson L EH1 S AH0 N
letter L EH1 T ER0
level L EH1 V AH0 L
lie L AY1
light L AY1 T
like L AY1 K
likely L AY1 K L IY0
limit L IH1 M AH0 T
line L AY1 N
lip L IH1 P
list L IH1 S T
local L OW1 K AH0 L
lock L AA1 K
longer L AO1 NG G ER0
look L UH1 K
lose L UW1 Z
lost L AO1 S T
loss L AO1 S
loud L AW1 D
low L OW1
lower L OW1 ER0
luck L AH1 K
lunch L AH1 N CH
mad M AE1 D
magazine M AE1 G AH0 Z IY2 N
main M EY1 N
maintain M EY0 N T EY1 N
major M EY1 JH ER0
majority M AH0 JH AO1 R AH0 T IY0
make M EY1 K
made M EY1 D
male M EY1 L
female F IY1 M EY0 L
manage M AE1 N IH0 JH
management M AE1 N IH0 JH M AH0 N T
manager M AE1 N IH0 JH ER0
march M AA1 R CH
market M AA1 R K IH0 T
marriage M EH1 R IH0 JH
marry M EH1 R IY0
married M EH1 R IY0 D
master M AE1 S T ER0
match M AE1 CH
material M AH0 T IH1 R IY0 AH0 L
matter M AE1 T ER0
may M EY1
maybe M EY1 B IY0
mayor M EY1 ER0
meal M IY1 L
media M IY1 D IY0 AH0
medical M EH1 D AH0 K AH0 L
medicine M EH1 D AH0 S AH0 N
meeting M IY1 T IH0 NG
member M EH1 M B ER0
memory M EH1 M ER0 IY0
mention M EH1 N SH AH0 N
message M EH1 S AH0 JH
metal M EH1 T AH0 L
method M EH1 TH AH0 D
middle M IH1 D AH0 L
midnight M IH1 D N AY2 T
mile M AY1 L
military M IH1 L AH0 T EH2 R IY0
milk M IH1 L K
mind M AY1 N D
mine M AY1 N
minute M IH1 N AH0 T
mirror M IH1 R ER0
miss M IH1 S
mission M IH1 SH AH0 N
mistake M IH0 S T EY1 K
model M AA1 D AH0 L
modern M AA1 D ER0 N
moment M OW1 M AH0 N T
monday M AH1 N D EY2
moon M UW1 N
moral M AO1 R AH0 L
mountain M AW1 N T AH0 N
mouth M AW1 TH
movement M UW1 V M AH0 N T
movie M UW1 V IY0
murder M ER1 D ER0
muscle M AH1 S AH0 L
museum M Y UW0 Z IY1 AH0 M
myself M AY0 S EH1 L F
name N EY1 M
narrow N EH1 R OW0
national N AE1 SH AH0 N AH0 L
natural N AE1 CH ER0 AH0 L
nature N EY1 CH ER0
near N IH1 R
nearly N IH1 R L IY0
necessary N EH1 S AH0 S EH2 R IY0
neck N EH1 K
need N IY1 D
neighbor N EY1 B ER0
neighborhood N EY1 B ER0 HH UH2 D
neither N IY1 DH ER0
nerve N ER1 V
network N EH1 T W ER2 K
news N UW1 Z
newspaper N UW1 Z P EY2 P ER0
next N EH1 K S T
nine N AY1 N
nobody N OW1 B AA2 D IY0
noise N OY1 Z
none N AH1 N
north N AO1 R TH
nose N OW1 Z
nothing N AH1 TH IH0 NG
notice N OW1 T AH0 S
november N OW0 V EH1 M B ER0
nuclear N UW1 K L IY0 ER0
number N AH1 M B ER0
nurse N ER1 S
occur AH0 K ER1
ocean OW1 SH AH0 N
october AA0 K T OW1 B ER0
offer AO1 F ER0
office AO1 F AH0 S
officer AO1 F AH0 S ER0
official AH0 F IH1 SH AH0 L
oil OY1 L
okay OW2 K EY1
open OW1 P AH0 N
operation AA2 P ER0 EY1 SH AH0 N
opinion AH0 P IH1 N Y AH0 N
opportunity AA2 P ER0 T UW1 N AH0 T IY0
option AA1 P SH AH0 N
orange AO1 R AH0 N JH
organization AO2 R G AH0 N AH0 Z EY1 SH AH0 N
others AH1 DH ER0 Z
outside AW1 T S AY1 D
oven AH1 V AH0 N
owner OW1 N ER0
page P EY1 JH
pain P EY1 N
paint P EY1 N T
pair P EH1 R
pants P AE1 N T S
paper P EY1 P ER0
parent P EH1 R AH0 N T
park P AA1 R K
particular P ER0 T IH1 K Y AH0 L ER0
particularly P ER0 T IH1 K Y AH0 L ER0 L IY0
partner P AA1 R T N ER0
party P AA1 R T IY0
pass P AE1 S
past P AE1 S T
patient P EY1 SH AH0 N T
pay P EY1
paid P EY1 D
peace P IY1 S
pen P EH1 N
pencil P EH1 N S AH0 L
per P ER1
perhaps P ER0 HH AE1 P S
period P IH1 R IY0 AH0 D
person P ER1 S AH0 N
personal P ER1 S AH0 N AH0 L
phone F OW1 N
photograph F OW1 T AH0 G R AE2 F
phrase F R EY1 Z
physical F IH1 Z IH0 K AH0 L
picture P IH1 K CH ER0
pink P IH1 NG K
plant P L AE1 N T
plastic P L AE1 S T IH0 K
plate P L EY1 T
platform P L AE1 T F AO2 R M
player P L EY1 ER0
pocket P AA1 K AH0 T
police P AH0 L IY1 S
policy P AA1 L AH0 S IY0
political P AH0 L IH1 T IH0 K AH0 L
politics P AA1 L AH0 T IH2 K S
pool P UW1 L
popular P AA1 P Y AH0 L ER0
population P AA2 P Y AH0 L EY1 SH AH0 N
position P AH0 Z IH1 SH AH0 N
positive P AA1 Z AH0 T IH0 V
possible P AA1 S AH0 B AH0 L
possibly P AA1 S AH0 B L IY0
pound P AW1 N D
practice P R AE1 K T AH0 S
prepare P R IY0 P EH1 R
present P R EH1 Z AH0 N T
pressure P R EH1 SH ER0
pretty P R IH1 T IY0
prevent P R IH0 V EH1 N T
price P R AY1 S
pride P R AY1 D
private P R AY1 V AH0 T
probably P R AA1 B AH0 B L IY0
process P R AA1 S EH2 S
produce P R AH0 D UW1 S
production P R AH0 D AH1 K SH AH0 N
professional P R AH0 F EH1 SH AH0 N AH0 L
professor P R AH0 F EH1 S ER0
profit P R AA1 F AH0 T
project P R AA1 JH EH0 K T
promise P R AA1 M AH0 S
property P R AA1 P ER0 T IY0
protect P R AH0 T EH1 K T
proud P R AW1 D
prove P R UW1 V
public P AH1 B L IH0 K
pull P UH1 L
purpose P ER1 P AH0 S
push P UH1 SH
quality K W AA1 L AH0 T IY0
quarter K W AO1 R T ER0
quick K W IH1 K
quickly K W IH1 K L IY0
quiet K W AY1 AH0 T
quite K W AY1 T
race R EY1 S
radio R EY1 D IY0 OW2
rain R EY1 N
raise R EY1 Z
range R EY1 N JH
rate R EY1 T
reach R IY1 CH
read R IY1 D
ready R EH1 D IY0
real R IY1 L
reality R IY0 AE1 L AH0 T IY0
realize R IY1 AH0 L AY2 Z
really R IH1 L IY0
reason R IY1 Z AH0 N
receive R AH0 S IY1 V
recent R IY1 S AH0 N T
recently R IY1 S AH0 N T L IY0
recognize R EH1 K AH0 G N AY2 Z
record R EH1 K ER0 D
red R EH1 D
reduce R IH0 D UW1 S
reflect R IH0 F L EH1 K T
region R IY1 JH AH0 N
relationship R IH0 L EY1 SH AH0 N SH IH2 P
religious R IH0 L IH1 JH AH0 S
report R IH0 P AO1 R T
represent R EH2 P R IH0 Z EH1 N T
republican R IH0 P AH1 B L AH0 K AH0 N
require R IY0 K W AY1 R
research R IY1 S ER0 CH
resource R IY1 S AO0 R S
respond R IH0 S P AA1 N D
response R IH0 S P AA1 N S
responsibility R IH0 S P AA2 N S AH0 B IH1 L AH0 T IY0
result R IH0 Z AH1 L T
return R IH0 T ER1 N
reveal R IH0 V IY1 L
rich R IH1 CH
ride R AY1 D
rode R OW1 D
ridden R IH1 D AH0 N
rise R AY1 Z
rose R OW1 Z
risen R IH1 Z AH0 N
risk R IH1 S K
river R IH1 V ER0
road R OW1 D
rock R AA1 K
role R OW1 L
roll R OW1 L
roof R UW1 F
rule R UW1 L
rush R AH1 SH
sad S AE1 D
safe S EY1 F
safety S EY1 F T IY0
salt S AO1 L T
sand S AE1 N D
saturday S AE1 T ER0 D EY2
save S EY1 V
scene S IY1 N
schedule S K EH1 JH UW0 L
science S AY1 AH0 N S
scientific S AY2 AH0 N T IH1 F IH0 K
screen S K R IY1 N
sea S IY1
season S IY1 Z AH0 N
seat S IY1 T
second S EH1 K AH0 N D
secret S IY1 K R AH0 T
secretary S EH1 K R AH0 T EH2 R IY0
section S EH1 K SH AH0 N
security S IH0 K Y UH1 R AH0 T IY0
sell S EH1 L
sold S OW1 L D
send S EH1 N D
sent S EH1 N T
senior S IY1 N Y ER0
september S EH0 P T EH1 M B ER0
series S IH1 R IY0 Z
serious S IH1 R IY0 AH0 S
serve S ER1 V
set S EH1 T
settle S EH1 T AH0 L
share SH EH1 R
shoe SH UW1
shoot SH UW1 T
shot SH AA1 T
shop SH AA1 P
short SH AO1 R T
shoulder SH OW1 L D ER0
shout SH AW1 T
sign S AY1 N
significant S IH0 G N IH1 F IH0 K AH0 N T
silence S AY1 L AH0 N S
silver S IH1 L V ER0
similar S IH1 M AH0 L ER0
single S IH1 NG G AH0 L
sir S ER1
sister S IH1 S T ER0
sit S IH1 T
sat S AE1 T
site S AY1 T
situation S IH2 CH UW0 EY1 SH AH0 N
size S AY1 Z
skill S K IH1 L
skin S K IH1 N
sky S K AY1
sleep S L IY1 P
slept S L EH1 P T
slightly S L AY1 T L IY0
smile S M AY1 L
smoke S M OW1 K
snow S N OW1
social S OW1 SH AH0 L
society S AH0 S AY1 AH0 T IY0
soft S AA1 F T
software S AO1 F T W EH2 R
soldier S OW1 L JH ER0
somebody S AH1 M B AA2 D IY0
someone S AH1 M W AH2 N
son S AH1 N
song S AO1 NG
soon S UW1 N
sorry S AA1 R IY0
sort S AO1 R T
soul S OW1 L
source S AO1 R S
south S AW1 TH
space S P EY1 S
speak S P IY1 K
spoke S P OW1 K
spoken S P OW1 K AH0 N
special S P EH1 SH AH0 L
specific S P AH0 S IH1 F IH0 K
speed S P IY1 D
spend S P EH1 N D
spent S P EH1 N T
sport S P AO1 R T
spot S P AA1 T
spread S P R EH1 D
spring S P R IH1 NG
staff S T AE1 F
stage S T EY1 JH
stair S T EH1 R
standard S T AE1 N D ER0 D
star S T AA1 R
statement S T EY1 T M AH0 N T
station S T EY1 SH AH0 N
status S T AE1 T AH0 S
step S T EH1 P
stick S T IH1 K
stuck S T AH1 K
stock S T AA1 K
stomach S T AH1 M AH0 K
stone S T OW1 N
stop S T AA1 P
store S T AO1 R
storm S T AO1 R M
straight S T R EY1 T
strange S T R EY1 N JH
street S T R IY1 T
strength S T R EH1 NG TH
stress S T R EH1 S
stretch S T R EH1 CH
strike S T R AY1 K
struck S T R AH1 K
strong S T R AO1 NG
student S T UW1 D AH0 N T
stuff S T AH1 F
stupid S T UW1 P AH0 D
subject S AH1 B JH IH0 K T
success S AH0 K S EH1 S
successful S AH0 K S EH1 S F AH0 L
such S AH1 CH
suddenly S AH1 D AH0 N L IY0
suffer S AH1 F ER0
suggest S AH0 G JH EH1 S T
summer S AH1 M ER0
sun S AH1 N
sunday S AH1 N D EY2
support S AH0 P AO1 R T
suppose S AH0 P OW1 Z
surface S ER1 F AH0 S
surprise S ER0 P R AY1 Z
sweet S W IY1 T
swim S W IH1 M
swam S W AE1 M
swum S W AH1 M
system S IH1 S T AH0 M
tail T EY1 L
tall T AO1 L
tax T AE1 K S
tea T IY1
teach T IY1 CH
taught T AO1 T
teacher T IY1 CH ER0
team T IY1 M
technology T EH0 K N AA1 L AH0 JH IY0
television T EH1 L AH0 V IH2 ZH AH0 N
temperature T EH1 M P R AH0 CH ER0
term T ER1 M
terrible T EH1 R AH0 B AH0 L
theory TH IY1 ER0 IY0
therefore DH EH1 R F AO2 R
thick TH IH1 K
thin TH IH1 N
third TH ER1 D
thirty TH ER1 D IY0
threat TH R EH1 T
three TH R IY1
throat TH R OW1 T
throw TH R OW1
threw TH R UW1
thrown TH R OW1 N
thursday TH ER1 Z D EY2
ticket T IH1 K AH0 T
tie T AY1
tiny T AY1 N IY0
tired T AY1 ER0 D
title T AY1 T AH0 L
tonight T AH0 N AY1 T
tooth T UW1 TH
teeth T IY1 TH
total T OW1 T AH0 L
touch T AH1 CH
tough T AH1 F
tour T UH1 R
town T AW1 N
track T R AE1 K
trade T R EY1 D
tradition T R AH0 D IH1 SH AH0 N
traditional T R AH0 D IH1 SH AH0 N AH0 L
traffic T R AE1 F IH0 K
train T R EY1 N
treat T R IY1 T
treatment T R IY1 T M AH0 N T
trial T R AY1 AH0 L
trip T R IH1 P
trouble T R AH1 B AH0 L
truck T R AH1 K
true T R UW1
trust T R AH1 S T
truth T R UW1 TH
tuesday T UW1 Z D EY2
turn T ER1 N
twelve T W EH1 L V
twice T W AY1 S
type T AY1 P
uncle AH1 NG K AH0 L
understand AH2 N D ER0 S T AE1 N D
understood AH2 N D ER0 S T UH1 D
unit Y UW1 N IH0 T
university Y UW2 N AH0 V ER1 S AH0 T IY0
unless AH0 N L EH1 S
until AH0 N T IH1 L
upon AH0 P AA1 N
usual Y UW1 ZH AH0 W AH0 L
value V AE1 L Y UW0
variety V ER0 AY1 AH0 T IY0
various V EH1 R IY0 AH0 S
vehicle V IY1 AH0 K AH0 L
version V ER1 ZH AH0 N
victim V IH1 K T AH0 M
victory V IH1 K T ER0 IY0
video V IH1 D IY0 OW2
view V Y UW1
village V IH1 L AH0 JH
violence V AY1 AH0 L AH0 N S
visit V IH1 Z AH0 T
vote V OW1 T
wait W EY1 T
wall W AO1 L
warn W AO1 R N
wash W AA1 SH
watch W AA1 CH
wave W EY1 V
weak W IY1 K
weapon W EH1 P AH0 N
wear W EH1 R
wore W AO1 R
worn W AO1 R N
weather W EH1 DH ER0
wednesday W EH1 N Z D EY2
weight W EY1 T
welcome W EH1 L K AH0 M
west W EH1 S T
wet W EH1 T
wide W AY1 D
wife W AY1 F
wild W AY1 L D
win W IH1 N
won W AH1 N
wind W IH1 N D
window W IH1 N D OW2
wine W AY1 N
wing W IH1 NG
winter W IH1 N T ER0
wish W IH1 SH
within W IH0 DH IH1 N
without W IH0 TH AW1 T
wonder W AH1 N D ER0
wonderful W AH1 N D ER0 F AH0 L
wood W UH1 D
worker W ER1 K ER0
worry W ER1 IY0
worth W ER1 TH
write R AY1 T
wrote R OW1 T
written R IH1 T AH0 N
writer R AY1 T ER0
wrong R AO1 NG
yard Y AA1 R D
yeah Y AE1
yellow Y EH1 L OW0
yes Y EH1 S
yesterday Y EH1 S T ER0 D EY2
yet Y EH1 T
young Y AH1 NG
yourself Y ER0 S EH1 L F
youth Y UW1 TH
zero Z IH1 R OW0
"""

# Contractions (stored literally; apostrophes are part of the word key).
_ARPA_TABLE += r"""
i'm AY1 M
i'll AY1 L
i've AY1 V
i'd AY1 D
you're Y UH1 R
you'll Y UW1 L
you've Y UW1 V
you'd Y UW1 D
we're W IY1 R
we'll W IY1 L
we've W IY1 V
we'd W IY1 D
they're DH EH1 R
they'll DH EY1 L
they've DH EY1 V
they'd DH EY1 D
he's HH IY1 Z
he'll HH IY1 L
he'd HH IY1 D
she's SH IY1 Z
she'll SH IY1 L
she'd SH IY1 D
it's IH1 T S
that's DH AE1 T S
there's DH EH1 R Z
here's HH IH1 R Z
what's W AH1 T S
who's HH UW1 Z
let's L EH1 T S
don't D OW1 N T
doesn't D AH1 Z AH0 N T
didn't D IH1 D AH0 N T
won't W OW1 N T
can't K AE1 N T
couldn't K UH1 D AH0 N T
shouldn't SH UH1 D AH0 N T
wouldn't W UH1 D AH0 N T
isn't IH1 Z AH0 N T
aren't AA1 R AH0 N T
wasn't W AH1 Z AH0 N T
weren't W ER1 AH0 N T
hasn't HH AE1 Z AH0 N T
haven't HH AE1 V AH0 N T
hadn't HH AE1 D AH0 N T
ain't EY1 N T
o'clock AH0 K L AA1 K
"""


def _parse_table(text: str) -> Dict[str, str]:
    table: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        parts = line.split()
        table[parts[0]] = arpa_to_ipa(parts[1:])
    return table


LEXICON_EN: Dict[str, str] = _parse_table(_ARPA_TABLE)


def _validate():
    from transformertts_torch.text.symbols import all_phonemes
    ok = set(all_phonemes)
    for word, ipa in LEXICON_EN.items():
        bad = [c for c in ipa if c not in ok]
        if bad:
            raise ValueError(f'lexicon_en: {word!r} -> {ipa!r} contains '
                             f'symbols outside the embedding inventory: {bad}')


_validate()

# ---------------------------------------------------------------------------
# Morphology: derive inflected forms from lemma entries.
# ---------------------------------------------------------------------------

_VOWELISH = set('iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻːɚ') | {'ɹ'}
_VOICELESS_FINAL = set('ptkfθ')
_SIBILANT_FINAL = ('s', 'z', 'ʃ', 'ʒ')  # tʃ/dʒ end in ʃ/ʒ


def _genitive(ipa: str) -> str:
    """-s / -'s: voicing-assimilated (cats -> s, dogs -> z, places -> ɪz)."""
    if ipa.endswith(_SIBILANT_FINAL):
        return _flap_join(ipa) + 'ɪz'
    if ipa[-1] in _VOICELESS_FINAL:
        return ipa + 's'
    return ipa + 'z'


def _past(ipa: str) -> str:
    """-ed: t/d -> ɪd, voiceless -> t, voiced -> d."""
    if ipa[-1] in 'td':
        return _flap_join(ipa) + 'ɪd'
    if ipa[-1] in _VOICELESS_FINAL:
        return ipa + 't'
    return ipa + 'd'


def _flap_join(ipa: str) -> str:
    """American flapping re-applies when a vowel-initial suffix lands after
    a final t with a vowel before it (create -> created kɹiːˈeɪɾɪd)."""
    if len(ipa) >= 2 and ipa[-1] == 't' and ipa[-2] in _VOWELISH:
        return ipa[:-1] + 'ɾ'
    return ipa


def _vowel_suffix(ipa: str, suffix: str) -> str:
    return _flap_join(ipa) + suffix


def lookup(word: str, extra: Optional[Dict[str, str]] = None
           ) -> Optional[Tuple[str, str]]:
    """Look ``word`` up in the table, deriving regular inflections.

    ``extra`` is an additional lemma dict consulted after the main table
    (g2p.py passes its curated irregulars so e.g. 'goes' derives from 'go').
    Returns (ipa, path) where path is 'cmudict' for direct hits and
    'cmudict_inflected' for derived forms, or None.
    """
    def base(w: str) -> Optional[str]:
        hit = LEXICON_EN.get(w)
        if hit is None and extra is not None:
            hit = extra.get(w)
        return hit

    direct = base(word)
    if direct is not None:
        return direct, 'cmudict'
    n = len(word)

    # possessives / n't
    if word.endswith("'s") and n > 2:
        b = lookup(word[:-2], extra)
        if b:
            return _genitive(b[0]), 'cmudict_inflected'
    if word.endswith("s'") and n > 2:
        b = lookup(word[:-1], extra)
        if b:
            return b[0], 'cmudict_inflected'
    if word.endswith("n't") and n > 3:
        b = base(word[:-3])
        if b:
            return b + 'ənt', 'cmudict_inflected'

    # -ing (look before -s/-ed so 'sings' doesn't shadow)
    if word.endswith('ing') and n > 4:
        for cand in (word[:-3], word[:-3] + 'e',
                     word[:-4] if n > 5 and word[-4] == word[-5] else None):
            b = base(cand) if cand else None
            if b:
                return _vowel_suffix(b, 'ɪŋ'), 'cmudict_inflected'

    # -ed / -ied
    if word.endswith('ied') and n > 4:
        b = base(word[:-3] + 'y')
        if b:
            return _past(b), 'cmudict_inflected'
    if word.endswith('ed') and n > 3:
        for cand in (word[:-1], word[:-2],
                     word[:-3] if n > 4 and word[-3] == word[-4] else None):
            b = base(cand) if cand else None
            if b:
                return _past(b), 'cmudict_inflected'

    # -ies / -es / -s (plural, 3rd person)
    if word.endswith('ies') and n > 4:
        b = base(word[:-3] + 'y')
        if b:
            return _genitive(b), 'cmudict_inflected'
    if word.endswith('s') and n > 2 and not word.endswith('ss'):
        for cand in (word[:-1], word[:-2] if word.endswith('es') else None):
            b = base(cand) if cand else None
            if b:
                return _genitive(b), 'cmudict_inflected'

    # -ly / -ily
    if word.endswith('ily') and n > 4:
        b = base(word[:-3] + 'y')
        if b:
            stem = b[:-1] if b.endswith('i') else b
            return stem + 'ɪli', 'cmudict_inflected'
    if word.endswith('ly') and n > 3:
        b = base(word[:-2])
        if b:
            return b + 'li', 'cmudict_inflected'

    # -er / -est (comparative/agentive)
    if word.endswith('iest') and n > 5:
        b = base(word[:-4] + 'y')
        if b:
            stem = b[:-1] if b.endswith('i') else b
            return stem + 'iɪst', 'cmudict_inflected'
    if word.endswith('ier') and n > 4:
        b = base(word[:-3] + 'y')
        if b:
            stem = b[:-1] if b.endswith('i') else b
            return _vowel_suffix(stem, 'iɚ'), 'cmudict_inflected'
    if word.endswith('est') and n > 4:
        for cand in (word[:-3], word[:-2],
                     word[:-4] if n > 5 and word[-4] == word[-5] else None):
            b = base(cand) if cand else None
            if b:
                return _vowel_suffix(b, 'ɪst'), 'cmudict_inflected'
    if word.endswith('er') and n > 3:
        for cand in (word[:-2], word[:-1],
                     word[:-3] if n > 4 and word[-3] == word[-4] else None):
            b = base(cand) if cand else None
            if b:
                return _vowel_suffix(b, 'ɚ'), 'cmudict_inflected'

    return None

